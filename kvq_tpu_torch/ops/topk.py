"""Top-k selection primitives (counterpart of kvq_tpu/ops/topk.py).

``perturbed_topk`` is the reference's PerturbedTopKFunction
(patchnet.py:83-128), the JAX package's custom_vjp, as a
``torch.autograd.Function``:

  forward:  hard top-k of ``num_samples`` Gaussian perturbations of the
            scores, indices sorted, one-hot, averaged -> (b, k, d);
  backward: dL/dx = <g, E[one_hot x noise] / sigma> (einsum
            "bnkd,bnd->bkd" / nS / sigma, then "bkd,bkd->bd"); zero when
            sigma <= 1e-20.

The other training indicators of QRS (kvq_tpu/ops/topk.py:64-72,
kvq_tpu/nn/regionnet.py:185-206), each (b, 1, d):

  - :func:`gumbel_topk_indicator`: straight-through Gumbel softmax, k=1,
    tau=1 (one-hot forward, the softmax's gradient backward);
  - :func:`categorical_indicator`: a categorical draw on
    ``log(scores + 1e-12)`` by the Gumbel-max rule, as
    ``jax.random.categorical`` draws it;
  - :func:`index_indicator`: the one-hot of given indices (sample type
    ``random``).

The random draw is an input of each: the caller draws it from an explicit
``torch.Generator`` (the JAX package from a PRNG key), so a test can hand
both the same numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hard_topk_indicator(x, k: int):
    """Exact top-k as a (b, k, d) one-hot indicator, indices sorted
    ascending (HardTopK semantics, reference patchnet.py:60)."""
    idx = torch.topk(x, k, dim=-1).indices.sort(dim=-1).values
    return F.one_hot(idx, x.shape[-1]).to(x.dtype)


def min_max_norm(x, dim: int = -1, eps: float = 1e-5):
    """Reference min_max_norm (patchnet.py:160-164)."""
    mn = x.amin(dim=dim, keepdim=True)
    mx = x.amax(dim=dim, keepdim=True)
    return (x - mn) / (mx - mn + eps)


class PerturbedTopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, noise, k: int, sigma: float):
        perturbed = x[:, None, :] + noise * sigma        # (b, nS, d)
        idx = torch.topk(perturbed, k, dim=-1).indices.sort(dim=-1).values
        onehot = F.one_hot(idx, x.shape[-1]).to(x.dtype)  # (b, nS, k, d)
        ctx.sigma = sigma
        ctx.save_for_backward(onehot, noise)
        return onehot.mean(dim=1)

    @staticmethod
    def backward(ctx, g):
        onehot, noise = ctx.saved_tensors
        if ctx.sigma <= 1e-20:
            return noise.new_zeros(noise.shape[::2]), None, None, None
        expected = (torch.einsum("bnkd,bnd->bkd", onehot, noise)
                    / noise.shape[1] / ctx.sigma)
        return torch.einsum("bkd,bkd->bd", g, expected), None, None, None


def perturbed_topk(x, noise, k: int, sigma: float):
    """x (b, d) scores, noise (b, num_samples, d) standard normal -> the
    (b, k, d) soft top-k indicator, differentiable in x."""
    return PerturbedTopK.apply(x, noise, k, float(sigma))


def gumbel_topk_indicator(x, uniform, tau: float = 1.0):
    """x (b, d) scores, uniform (b, d) draws in [0, 1) -> the (b, 1, d)
    straight-through Gumbel-softmax indicator (reference gumbel_softmax,
    patchnet.py:366-390): the hard one-hot forward, the gradient of
    softmax((x + g) / tau) backward."""
    g = -torch.log(-torch.log(uniform + 1e-20) + 1e-20)
    y_soft = ((x + g) / tau).softmax(dim=-1)
    y_hard = F.one_hot(y_soft.argmax(dim=-1), x.shape[-1]).to(x.dtype)
    return (y_hard - y_soft.detach() + y_soft)[:, None, :]


def categorical_indicator(x, gumbel):
    """x (b, d) scores in [0, 1], gumbel (b, d) standard Gumbel draws ->
    the (b, 1, d) one-hot of a draw with P(i) proportional to x_i."""
    idx = (gumbel + torch.log(x + 1e-12)).argmax(dim=-1)
    return index_indicator(idx, x.shape[-1], x.dtype)


def index_indicator(idx, d: int, dtype):
    """idx (b,) -> the (b, 1, d) one-hot indicator."""
    return F.one_hot(idx.long(), d).to(dtype)[:, None, :]
