"""Hierarchical namespace relatedness: a copy of the JAX package's
``utils/namespaces.py`` gate (the reference's ``areNamespacesRelated``,
``MembershipProtocolImpl.java:511-536``): two namespaces are related iff
one is a path-component prefix of the other (equal counts but different
components are unrelated)."""

from __future__ import annotations


def _components(namespace: str) -> list:
    return [c for c in namespace.split("/") if c]


def are_namespaces_related(ns1: str, ns2: str) -> bool:
    """True iff ns1 == ns2 or one is a strict path-prefix of the other."""
    c1, c2 = _components(ns1), _components(ns2)
    if c1 == c2:
        return True
    if len(c1) == len(c2):
        return False
    shorter, longer = (c1, c2) if len(c1) < len(c2) else (c2, c1)
    return longer[: len(shorter)] == shorter
