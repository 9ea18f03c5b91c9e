"""The adaptive failure-detection plane in PyTorch: Lifeguard-style local
health and confirmation-scaled suspicion. A port of the JAX package's
``adaptive.py``, whose docstring carries the mechanism and its deviations
AD-1 to AD-5; the formulas here are the same integer and f32 operations in
the same order, so each engine's adaptive window is held against the JAX
one bit for bit (``tests/test_torch_adaptive*.py``).

* :class:`AdaptiveSpec` — one hashable spec, ``params.adaptive`` on every
  engine's params. The default (``enabled=False``) runs the engines'
  static windows unchanged: no adaptive operation runs unless the spec is
  enabled.
* :class:`AdaptiveState` — three int32 [N] planes on the state's device:
  ``lh`` (local health, in ``[0, lh_max]``), ``conf_key`` (the suspicion
  episode per subject) and ``conf`` (its confirmations, saturated at
  ``conf_target``).
* :func:`fold` — the end-of-tick update from the tick's evidence;
  :func:`conf_mult_num` — the suspicion multiplier's numerator;
  :func:`scaled_timely_rt` — the direct probe's timeliness under the delay
  rings with the timeout stretched to ``t_base * (1 + lh)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: scatter-max identity shared with the engines' key planes
NO_CANDIDATE = int(np.iinfo(np.int32).min)


@dataclasses.dataclass(frozen=True)
class AdaptiveSpec:
    """Hashable adaptive-FD spec; the default is the static program.

    ``lh_max`` caps the local-health score (the probe timeout and the sweep
    scale by at most ``1 + lh_max``); the suspicion multiplier interpolates
    from ``max_mult`` (a lone accusation) down to ``min_mult`` at
    ``conf_target`` confirmations."""

    enabled: bool = False
    lh_max: int = 8
    min_mult: int = 5
    max_mult: int = 10
    conf_target: int = 4

    def __post_init__(self):
        if self.lh_max < 0:
            raise ValueError("lh_max must be >= 0")
        if self.min_mult < 1:
            raise ValueError("min_mult must be >= 1")
        if self.max_mult < self.min_mult:
            raise ValueError("max_mult must be >= min_mult")
        if self.conf_target < 1:
            raise ValueError("conf_target must be >= 1")

    @property
    def is_default(self) -> bool:
        """True iff the spec selects the static program."""
        return not self.enabled

    @property
    def levels(self) -> int:
        """The log-scale denominator L = bit_length(conf_target)."""
        return max(1, int(self.conf_target).bit_length())

    @staticmethod
    def from_config(config) -> "AdaptiveSpec":
        """Map a ``ClusterConfig.adaptive`` block (or an absent one)."""
        ac = getattr(config, "adaptive", None)
        if ac is None:
            return AdaptiveSpec()
        return AdaptiveSpec(
            enabled=ac.enabled,
            lh_max=ac.lh_max,
            min_mult=ac.min_mult,
            max_mult=ac.max_mult,
            conf_target=ac.conf_target,
        )


#: the one shared default instance (``params.adaptive`` default value)
DEFAULT = AdaptiveSpec()


@dataclasses.dataclass
class AdaptiveState:
    """The adaptive plane's state, the same on every engine: three int32
    [N] tensors on the engine state's device."""

    lh: torch.Tensor  # i32 [N] — local-health score, in [0, lh_max]
    conf_key: torch.Tensor  # i32 [N] — suspicion episode key (NO_CANDIDATE: none)
    conf: torch.Tensor  # i32 [N] — confirmations, saturated at conf_target


def init_adaptive_state(capacity: int, device="cuda") -> AdaptiveState:
    return AdaptiveState(
        lh=torch.zeros((capacity,), dtype=torch.int32, device=device),
        conf_key=torch.full((capacity,), NO_CANDIDATE, dtype=torch.int32, device=device),
        conf=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


def adaptive_state_arrays(ad: AdaptiveState) -> dict:
    """Checkpoint view (host numpy) of the adaptive planes."""
    return {
        "_ad_lh": ad.lh.cpu().numpy(),
        "_ad_conf_key": ad.conf_key.cpu().numpy(),
        "_ad_conf": ad.conf.cpu().numpy(),
    }


def restore_adaptive_state(arrays: dict, device="cuda") -> AdaptiveState:
    """Inverse of :func:`adaptive_state_arrays`, onto ``device``; the planes
    are copied, never aliased to the caller's buffers."""

    def t(name):
        return torch.from_numpy(np.array(arrays[name], dtype=np.int32, copy=True)).to(device)

    return AdaptiveState(lh=t("_ad_lh"), conf_key=t("_ad_conf_key"), conf=t("_ad_conf"))


# ---------------------------------------------------------------------------
# shared math
# ---------------------------------------------------------------------------


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``int.bit_length`` of small non-negative int tensors, by
    compare-and-count (int32)."""
    x = x.to(torch.int32)
    powers = torch.ones((), dtype=torch.int32, device=x.device) << torch.arange(
        31, dtype=torch.int32, device=x.device
    )
    return (x[..., None] >= powers).sum(dim=-1, dtype=torch.int32)


def conf_mult_num(spec: AdaptiveSpec, conf: torch.Tensor) -> torch.Tensor:
    """Numerator of the confirmation-scaled suspicion multiplier, per
    subject: ``max_mult * L - (max_mult - min_mult) * bit_length(min(conf,
    K))`` with ``L = bit_length(K)``. The sweeps compute ``timeout = base *
    num * (1 + lh) // L`` in integers."""
    L = spec.levels
    c = torch.clamp(conf.to(torch.int32), max=spec.conf_target)
    return (spec.max_mult * L - (spec.max_mult - spec.min_mult) * bit_length(c)).to(torch.int32)


def conf_mult_num_scalar(spec: AdaptiveSpec, conf: int) -> int:
    """:func:`conf_mult_num` for one subject, on the host."""
    L = spec.levels
    c = min(int(conf), spec.conf_target)
    return spec.max_mult * L - (spec.max_mult - spec.min_mult) * int(c).bit_length()


def fold(spec: AdaptiveSpec, lh, conf_key, conf, *, acc_key, acc_cnt, miss, succ, refuted, up):
    """End-of-tick adaptive-state fold, on the PRE-tick planes.

    ``lh`` moves by ``miss + refuted - succ``, clamps to ``[0, lh_max]`` and
    resets to 0 on down rows. ``acc_key``/``acc_cnt`` are the per-subject
    max accepted SUSPECT key and the accepted-SUSPECT count of every merge
    site this tick: a higher key supersedes the episode (the count restarts
    at this tick's arrivals), an equal or lower one confirms it; the count
    saturates at ``conf_target``. Returns ``(lh', conf_key', conf')``."""
    i32 = torch.int32
    lh2 = lh.to(i32) + miss.to(i32) + refuted.to(i32) - succ.to(i32)
    lh2 = torch.clamp(lh2, 0, spec.lh_max).to(i32)
    lh_new = torch.where(up, lh2, 0).to(i32)
    ck = conf_key.to(i32)
    ak = acc_key.to(i32)
    supersede = ak > ck
    conf_key_new = torch.maximum(ck, ak)
    base = torch.where(supersede, 0, conf.to(i32))
    conf_new = torch.clamp(base + acc_cnt.to(i32), max=spec.conf_target).to(i32)
    return lh_new, conf_key_new, conf_new


def scaled_timely_rt(q1: torch.Tensor, q2: torch.Tensor, t_base: int, lh: torch.Tensor,
                     lh_max: int) -> torch.Tensor:
    """The direct probe's timeliness with the timeout stretched per row:
    ``P(round trip <= t_base * (1 + lh))`` under the geometric link-delay
    model. The recurrence of the dense engine's ``_timely_rt`` runs out to
    ``t_base * (1 + lh_max)`` steps, each product and sum its own f32
    operation in the JAX order, capturing the partial sum at every
    multiple of ``t_base``; each row takes its own capture."""
    if t_base <= 0:
        one = torch.ones_like(q1)
        return (1.0 - q1) * (1.0 - q2) * one
    h = torch.ones_like(q1)
    acc = h
    q2p = torch.ones_like(q2)
    captures = []
    for step in range(1, t_base * (1 + lh_max) + 1):
        q2p = q2p * q2
        h = q1 * h
        h = h + q2p
        acc = acc + h
        if step % t_base == 0:
            captures.append(acc)
    table = torch.stack(captures, 0)  # [1 + lh_max, ...rows]
    idx = torch.clamp(lh.to(torch.int64), 0, lh_max)
    sel = torch.gather(table, 0, idx[None, ...].expand((1,) + table.shape[1:]))[0]
    return (1.0 - q1) * (1.0 - q2) * sel
