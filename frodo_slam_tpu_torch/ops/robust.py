"""Robust kernels and Gauss-Newton convergence tests.

Spec: ``mast3r_slam/nonlinear_optimizer.py:5-42`` and the device-side Huber
weight in ``gn_kernels.cu:214-217``.
"""

from __future__ import annotations

import torch

# the Huber threshold of the window solves (nonlinear_optimizer.py:28)
HUBER_K = 1.345


def huber(r: torch.Tensor, k: float = HUBER_K) -> torch.Tensor:
    """Huber IRLS weight: 1 inside the kernel, k/|r| outside
    (nonlinear_optimizer.py:28-33)."""
    r_abs = torch.abs(r)
    return torch.where(r_abs < k, torch.ones_like(r), k / r_abs)


def tukey(r: torch.Tensor, k: float = 4.6851) -> torch.Tensor:
    """Tukey biweight (nonlinear_optimizer.py:36-42)."""
    r_abs = torch.abs(r)
    tmp = 1.0 - (r_abs / k) ** 2
    return torch.where(r_abs < k, tmp * tmp, torch.zeros_like(r))


def check_convergence(
    step, rel_error_thresh, delta_norm_thresh, old_cost, new_cost, delta
) -> torch.Tensor:
    """Relative-cost + step-norm termination (nonlinear_optimizer.py:5-25).
    Returns a boolean tensor; ``step`` is a host int."""
    rel = torch.abs(new_cost - old_cost) / torch.clamp(new_cost, min=1e-12)
    dn = torch.linalg.norm(delta)
    return ((rel < rel_error_thresh) | (dn < delta_norm_thresh)) & (step > 0)
