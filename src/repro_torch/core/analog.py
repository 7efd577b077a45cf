"""Analog model of triple-row activation (Section 3.1.1 / Section 6).

Implements Equation 1 generalized to varied per-cell capacitances, plus a
Monte-Carlo harness over process variation that reproduces the *trend* of
Table 3 (the paper used transistor-level SPICE; we use the charge-sharing
equation with a sense-amplifier offset term, calibrated so the failure
onset matches the paper's: 0% at +-5%, <1% at +-10%, single-digit % at
+-15%, tens of % at +-25%).

Model:
  delta = (sum_i q_i Cc_i Vdd + Cb Vdd/2) / (sum_i Cc_i + Cb) - Vdd/2
  with q_i in {0, U(1 - v*Q_RESTORE_SCALE, 1)}  (incomplete-restore /
  access-transistor variation scales with process variation v), and TRA
  resolves correctly iff sign(delta - V_off) == sign(ideal majority), where
  V_off ~ U(-v, v) * V_OFF_SCALE * Vdd is the sense-amp offset.

Constants: Cc = 22 fF (Rambus model, Section 6); Cb/Cc = 3.63 (typical for
512-cell bitlines); V_OFF_SCALE and Q_RESTORE_SCALE calibrated numerically
(see benchmarks/table3_variation.py). Calibrated model vs Table 3:
  +-5%: 0.00% vs 0.00%   +-10%: 0.24% vs 0.29%   +-15%: 6.13% vs 6.01%
  +-20%: 12.7% vs 16.4%  +-25%: 17.7% vs 26.2%  (trend reproduced; deep
tail underestimates SPICE, where transistor-level effects compound).

The Monte-Carlo's arithmetic runs in float64 on tensors on ``device`` (the
card unless the caller names another; the worst-case margin is a scalar
bisection in Python floats); the Monte-Carlo draws come from the reference
package's numpy generator in the reference's order, so the failure rates
come out equal to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bitvector import resolve_device

VDD = 1.2  # volts (DDR3)
CC_NOMINAL_FF = 22.0
CB_OVER_CC = 3.63
# Calibrated so Monte-Carlo failure rates track Table 3 (see table3 benchmark).
V_OFF_SCALE = 0.50
Q_RESTORE_SCALE = 1.0


@dataclasses.dataclass(frozen=True)
class AnalogParams:
    vdd: float = VDD
    cc_ff: float = CC_NOMINAL_FF
    cb_over_cc: float = CB_OVER_CC
    v_off_scale: float = V_OFF_SCALE
    q_restore_scale: float = Q_RESTORE_SCALE


def bitline_deviation(charges: torch.Tensor, cc: torch.Tensor,
                      cb: torch.Tensor, vdd: float = VDD) -> torch.Tensor:
    """Equation 1, generalized: charges/cc are (..., k) tensors for k
    cells."""
    num = (charges * cc).sum(-1) * vdd + cb * 0.5 * vdd
    den = cc.sum(-1) + cb
    return num / den - 0.5 * vdd


def ideal_majority(bits: torch.Tensor) -> torch.Tensor:
    """(..., k) -> (...) boolean majority."""
    return bits.sum(-1) * 2 > bits.shape[-1]


def tra_failure_rate(variation: float, n_trials: int = 100_000,
                     params: AnalogParams = AnalogParams(),
                     seed: int = 0, device=None) -> float:
    """Monte-Carlo fraction of TRAs resolving the wrong value (Table 3).

    Each trial samples three fully-refreshed cells with uniformly varied
    capacitances, a varied bitline capacitance, and a sense-amp offset with
    spread proportional to the variation level. Cell contents are sampled
    uniformly from the 8 possible states (failures are dominated by k=1,2
    borderline cases, as in the paper)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    v = variation

    def draw(x):
        return torch.from_numpy(np.asarray(x, np.float64)).to(dev)

    bits = draw(rng.integers(0, 2, size=(n_trials, 3)))
    cc = params.cc_ff * draw(rng.uniform(1 - v, 1 + v, size=(n_trials, 3)))
    cb = params.cc_ff * params.cb_over_cc * draw(
        rng.uniform(1 - v, 1 + v, size=n_trials))
    # Incomplete restore / access-transistor strength variation on charged
    # cells: stored charge in [1 - v*q_scale, 1] of full.
    q = bits * draw(rng.uniform(1 - v * params.q_restore_scale, 1.0,
                                size=(n_trials, 3)))
    v_off = draw(rng.uniform(-v, v, size=n_trials)) * params.v_off_scale \
        * params.vdd
    delta = bitline_deviation(q, cc, cb, params.vdd)
    resolved_one = (delta - v_off) > 0
    expect_one = ideal_majority(bits)
    # an integer count over n_trials: the float numpy's mean gives
    return int((resolved_one != expect_one).sum()) / n_trials


def tra_worst_case_margin(params: AnalogParams = AnalogParams(),
                          resolution: float = 1e-4) -> float:
    """Largest variation v at which TRA still resolves correctly when *every*
    component deviates adversarially (Section 6: paper reports ~+-6%).

    Worst case for k=2 (two charged cells): both charged cells at (1-v)Cc,
    the empty cell at (1+v)Cc, bitline at (1+v)Cb, sense offset at +v*scale.
    A scalar bisection: Equation 1 in Python floats, on no device.
    """
    lo, hi = 0.0, 0.5
    while hi - lo > resolution:
        v = 0.5 * (lo + hi)
        cc = [c * params.cc_ff for c in ((1 - v), (1 - v), (1 + v))]
        charges = [1.0 - v * params.q_restore_scale,
                   1.0 - v * params.q_restore_scale, 0.0]
        cb = params.cc_ff * params.cb_over_cc * (1 + v)
        num = (sum(q * c for q, c in zip(charges, cc)) * params.vdd
               + cb * 0.5 * params.vdd)
        delta = num / (sum(cc) + cb) - 0.5 * params.vdd
        ok = (delta - v * params.v_off_scale * params.vdd) > 0
        if ok:
            lo = v
        else:
            hi = v
    return lo
