"""Namespace validation and hierarchical relatedness: a copy of the JAX
package's ``utils/namespaces.py`` — the reference's validation pattern
``^(\\w+[\\w\\-./]*\\w)+`` (``ClusterImpl.java:60,350``) and its gate
``areNamespacesRelated`` (``MembershipProtocolImpl.java:511-536``): two
namespaces are related iff one is a path-component prefix of the other
(equal counts but different components are unrelated)."""

from __future__ import annotations

import re

_NAMESPACE_RE = re.compile(r"^(\w+[\w\-./]*\w)+$")


def is_valid_namespace(namespace: str) -> bool:
    """True if ``namespace`` matches the reference validation pattern."""
    return bool(_NAMESPACE_RE.match(namespace))


def validate_namespace(namespace: str) -> str:
    if not is_valid_namespace(namespace):
        raise ValueError(f"invalid cluster namespace format: {namespace!r}")
    return namespace


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
