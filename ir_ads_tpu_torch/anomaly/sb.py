"""Light Schrödinger Bridge (LightSB): counterpart of
ir_ads_tpu/anomaly/sb.py.

Parameters are a ``LightSBParams`` of tensors; every function is plain
PyTorch and differentiable in them.  The rotated (non-diagonal) covariance
is Q diag(e^l) Q^T with Q = qr(S_rot_raw): Q's column signs may differ from
JAX's, and every output here is invariant to them.  The random draws the
JAX functions take from a key come in as tensors:

  ``sample_posterior(..., gumbel, noise)``: ``jax.random.categorical`` is
    the argmax of the logits plus Gumbel noise (``gumbel``, (B, n)); the
    normal draw is ``noise`` (B, dim);
  ``sample_euler_maruyama(..., noise)``: the step noises, (n_steps, B, dim);
  ``sample_at_time_moment(..., gumbel, noise_posterior, noise)``.

``get_drift`` takes the gradient of the summed logsumexp with
``torch.autograd.grad`` under ``torch.enable_grad()``, so it also runs
inside a ``no_grad`` region.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class LightSBParams(NamedTuple):
    log_alpha_raw: torch.Tensor  # (n,)
    r: torch.Tensor  # (n, dim)
    S_log_diag: torch.Tensor  # (n, dim)
    S_rot_raw: Optional[torch.Tensor] = None  # (n, dim, dim), None = diagonal


def init_lightsb(generator: torch.Generator, dim: int = 512, n_potentials: int = 10,
                 epsilon: float = 0.1, is_diagonal: bool = True,
                 s_diag_init: float = 0.1) -> Tuple[LightSBParams, float]:
    """Parameters on the generator's device: r and S_rot_raw drawn N(0, 1)
    from ``generator`` (in that order)."""
    dev = generator.device
    r = torch.randn(n_potentials, dim, generator=generator, device=dev)
    rot = None if is_diagonal else torch.randn(n_potentials, dim, dim, generator=generator,
                                               device=dev)
    params = LightSBParams(
        log_alpha_raw=epsilon * torch.log(torch.ones(n_potentials, device=dev) / n_potentials),
        r=r,
        S_log_diag=torch.log(s_diag_init * torch.ones(n_potentials, dim, device=dev)),
        S_rot_raw=rot,
    )
    return params, epsilon


def init_r_by_samples(params: LightSBParams, samples: torch.Tensor) -> LightSBParams:
    assert samples.shape[0] == params.r.shape[0]
    return params._replace(r=torch.as_tensor(samples, device=params.r.device))


def _rotation(params: LightSBParams) -> torch.Tensor:
    q, _ = torch.linalg.qr(params.S_rot_raw)
    return q


def get_S(params: LightSBParams) -> torch.Tensor:
    """Diagonal: (n, dim).  Rotated: (n, dim, dim) = Q diag(e^l) Q^T."""
    diag = torch.exp(params.S_log_diag)
    if params.S_rot_raw is None:
        return diag
    q = _rotation(params)
    return (q * diag[:, None, :]) @ q.transpose(1, 2)


def get_log_alpha(params: LightSBParams, epsilon: float) -> torch.Tensor:
    return params.log_alpha_raw / epsilon


def _exp_argument(params: LightSBParams, epsilon: float,
                  x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixture logits (B, n) and component means r_x (B, n, dim) of the
    posterior GMM at x."""
    S = get_S(params)
    r = params.r
    log_alpha = get_log_alpha(params, epsilon)
    if params.S_rot_raw is None:
        x_S_x = torch.einsum("bd,nd,bd->bn", x, S, x)
        r_x = r[None] + S[None] * x[:, None, :]
    else:
        Sx = torch.einsum("nde,be->bnd", S, x)
        x_S_x = torch.einsum("bd,bnd->bn", x, Sx)
        r_x = r[None] + Sx
    x_r = torch.einsum("bd,nd->bn", x, r)
    logits = (x_S_x + 2 * x_r) / (2 * epsilon) + log_alpha[None]
    return logits, r_x


def sample_posterior(params: LightSBParams, epsilon: float, x: torch.Tensor,
                     gumbel: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """y ~ the posterior GMM at x: component argmax(logits + gumbel), then
    its mean plus the covariance's factor times ``noise``."""
    logits, r_x = _exp_argument(params, epsilon, x)
    comp = torch.argmax(logits + gumbel, dim=-1)  # (B,)
    mean = torch.take_along_dim(r_x, comp[:, None, None], dim=1)[:, 0]  # (B, dim)
    S = get_S(params)[comp]
    if params.S_rot_raw is None:
        return mean + torch.sqrt(epsilon * S) * noise
    chol = torch.linalg.cholesky(epsilon * S)  # (B, dim, dim)
    return mean + torch.einsum("bde,be->bd", chol, noise)


def get_log_C(params: LightSBParams, epsilon: float, x: torch.Tensor) -> torch.Tensor:
    logits, _ = _exp_argument(params, epsilon, x)
    return torch.logsumexp(logits, dim=-1)


def get_log_potential(params: LightSBParams, epsilon: float, x: torch.Tensor) -> torch.Tensor:
    """log v(y) = log GMM(y) + logsumexp(log_alpha)."""
    S = get_S(params)
    r = params.r
    log_alpha = get_log_alpha(params, epsilon)
    d = x.shape[-1]
    diff = x[:, None, :] - r[None]
    if params.S_rot_raw is None:
        var = epsilon * S  # (n, dim)
        log_comp = -0.5 * (torch.sum(diff ** 2 / var[None], dim=-1)
                           + torch.sum(torch.log(2 * math.pi * var), dim=-1)[None])
    else:
        chol = torch.linalg.cholesky(epsilon * S)  # (n, dim, dim)
        # one solve a component with the batch as its columns
        sol = torch.linalg.solve_triangular(chol, diff.permute(1, 2, 0), upper=False)
        sol = sol.permute(2, 0, 1)  # (B, n, dim)
        logdet = 2 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
        log_comp = -0.5 * (torch.sum(sol ** 2, -1) + logdet[None] + d * math.log(2 * math.pi))
    mix = torch.log_softmax(log_alpha, dim=-1)
    return torch.logsumexp(mix[None] + log_comp, dim=-1) + torch.logsumexp(log_alpha, dim=-1)


def _drift_lse(params: LightSBParams, epsilon: float, x: torch.Tensor,
               t: torch.Tensor) -> torch.Tensor:
    """The summed logsumexp whose x-gradient, times epsilon, is the drift's
    second term."""
    S_diag = torch.exp(params.S_log_diag)  # (n, dim)
    log_alpha = get_log_alpha(params, epsilon)
    S_log_det = torch.sum(params.S_log_diag, dim=-1)  # (n,)
    A_diag = (t / (epsilon * (1 - t)))[:, None, None] + (1.0 / (epsilon * S_diag))[None]
    A_log_det = torch.sum(torch.log(A_diag), dim=-1)  # (B, n)
    x_term = ((1.0 / (epsilon * (1 - t)))[:, None] * x)[:, None, :]
    if params.S_rot_raw is None:
        c = x_term + (params.r / (epsilon * S_diag))[None]
        r_S_inv_r = torch.sum(params.r ** 2 / S_diag, dim=-1) / epsilon  # (n,)
        c_A_inv_c = torch.sum(c ** 2 / A_diag, dim=-1)
    else:
        q = _rotation(params)
        S_inv = (q * (1.0 / S_diag)[:, None, :]) @ q.transpose(1, 2)
        c = x_term + (torch.einsum("nde,ne->nd", S_inv, params.r) / epsilon)[None]
        cq = torch.einsum("bnd,nde->bne", c, q)
        c_A_inv_c = torch.sum(cq ** 2 * (1.0 / A_diag), dim=-1)
        r_S_inv_r = torch.einsum("nd,nde,ne->n", params.r, S_inv, params.r) / epsilon
    exp_arg = (log_alpha[None] - 0.5 * S_log_det[None] - 0.5 * A_log_det
               - 0.5 * r_S_inv_r[None] + 0.5 * c_A_inv_c)
    return torch.sum(torch.logsumexp(exp_arg, dim=-1))


def get_drift(params: LightSBParams, epsilon: float, x: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """The SDE drift at (x, t), t: (B,)."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(_drift_lse(params, epsilon, xg, t), xg,
                                      create_graph=outer)
    return -x / (1 - t[:, None]) + epsilon * grad


def sample_euler_maruyama(params: LightSBParams, epsilon: float, x: torch.Tensor,
                          noise: torch.Tensor) -> torch.Tensor:
    """The SDE rollout over ``noise.shape[0]`` steps; returns the trajectory
    (B, n_steps + 1, dim)."""
    n_steps = noise.shape[0]
    dt = 1.0 / n_steps
    scale = math.sqrt(dt) * math.sqrt(epsilon)
    t = torch.zeros(x.shape[0], device=x.device, dtype=x.dtype)
    traj = [x]
    for i in range(n_steps):
        x = x + get_drift(params, epsilon, x, t) * dt + scale * noise[i]
        t = t + dt
        traj.append(x)
    return torch.stack(traj, dim=1)


def sample_at_time_moment(params: LightSBParams, epsilon: float, x: torch.Tensor,
                          t, gumbel: torch.Tensor, noise_posterior: torch.Tensor,
                          noise: torch.Tensor) -> torch.Tensor:
    """The Brownian-bridge interpolant at t between x and a posterior
    sample (``sample_posterior``'s draws, then the bridge's ``noise``)."""
    y = sample_posterior(params, epsilon, x, gumbel, noise_posterior)
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(x.shape[0], 1)
    return t * y + (1 - t) * x + torch.sqrt(t * (1 - t) * epsilon) * noise
