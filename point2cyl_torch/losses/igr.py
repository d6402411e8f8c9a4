"""IGR implicit-sketch losses: manifold, eikonal, SALD-style normal and
latent (the port of the JAX ``losses/igr.py``; reference
``train_Point2Cyl.py:608-672``).

The SDF's gradient with respect to its 2D input points comes from one
``torch.autograd.grad(sdf.sum(), x, create_graph=True)`` (each output
depends only on its own point), over the on-sketch and the off-surface
points together: one decoder pass gives the on-sketch SDF, its gradient
and the off-surface gradient. The loss's own backward is then a double
backward through the decoder's softplus, into the latents (and so into
the encoder) and, where they require a gradient, into the decoder's
weights.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from point2cyl_torch.models.implicit import add_latent, sample_off_surface
from point2cyl_torch.ops.matching import reduce_mean_masked_instance


class IGRLosses(NamedTuple):
    total: torch.Tensor
    manifold: torch.Tensor
    eikonal: torch.Tensor
    normals: torch.Tensor


def _per_instance(
    decoder: torch.nn.Module,
    pts: torch.Tensor,
    latents: torch.Tensor,
    normals: torch.Tensor,
    off_pts: torch.Tensor,
) -> torch.Tensor:
    """(c, S, 2), (c, L), (c, S, 2), (c, S', 2) -> (3, c): the manifold,
    eikonal and SALD loss of each instance."""
    s = pts.shape[1]
    x = torch.cat([pts, off_pts], dim=1)
    if not x.requires_grad:
        x.requires_grad_()
    sdf = decoder(add_latent(x, latents))  # (c, S + S', 1)
    (grad,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
    mnfld = sdf[:, :s, 0].abs().mean(dim=-1)
    grad_norm = torch.linalg.vector_norm(grad[:, s:], dim=-1)
    eik = ((grad_norm - 1.0) ** 2).mean(dim=-1)
    # SALD: unsigned normal agreement min(|g - n|, |g + n|)
    g = grad[:, :s]
    sald = torch.minimum(torch.linalg.vector_norm(g - normals, dim=-1),
                         torch.linalg.vector_norm(g + normals, dim=-1)).mean(dim=-1)
    return torch.stack([mnfld, eik, sald])


class _RecomputedChunk(torch.autograd.Function):
    """``_per_instance`` of one chunk that keeps no activations: the
    forward discards its graph, and the backward recomputes the chunk and
    differentiates it (the role of the JAX ``jax.checkpoint``), so only
    one chunk's double-backward graph is alive at a time. The decoder's
    parameters are inputs, so that they get their gradients."""

    @staticmethod
    def forward(ctx, decoder, pts, latents, normals, off_pts, *params):
        ctx.decoder = decoder
        ctx.save_for_backward(pts, latents, normals, off_pts, *params)
        with torch.enable_grad():
            return _per_instance(decoder, pts.detach(), latents.detach(), normals.detach(),
                                 off_pts.detach()).detach()

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        wanted = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) for t, w in zip(saved[:4], wanted[:4])]
            per = _per_instance(ctx.decoder, *inputs)
            targets = [t for t, w in zip([*inputs, *saved[4:]], wanted) if w]
            grads = iter(torch.autograd.grad(per, targets, grad_out, allow_unused=True))
        return (None, *(next(grads) if w else None for w in wanted))


def igr_losses(
    decoder: torch.nn.Module,
    generator: torch.Generator | None,
    sk_pts: torch.Tensor,
    sk_normals: torch.Tensor,
    latents: torch.Tensor,
    mask_gt: torch.Tensor,
    eikonal_weight: float = 0.1,
    normals_weight: float = 1.0,
    off_pts: torch.Tensor | None = None,
    chunk_size: int | None = None,
) -> IGRLosses:
    """Implicit-surface fitting losses over per-instance sketches.

    Args:
      decoder: maps (M, S', L + 2) latent-conditioned points to (M, S', 1)
        signed distances.
      generator: the draw of the off-surface samples when ``off_pts`` is
        None (``sample_off_surface``).
      sk_pts, sk_normals: (B, K, S, 2) on-sketch points and normals.
      latents: (B, K, L).
      mask_gt: (B, K) bool, the valid instances.
      off_pts: optional (B*K, S', 2) off-surface samples (tests inject
        the JAX side's).
      chunk_size: when set and below B*K, the instances go through the
        decoder in chunks of the largest divisor of B*K not above it,
        each recomputed in the backward instead of kept, so the memory of
        the double backward is one chunk's; the values and gradients are
        the unchunked ones.

    Returns scalars: total = manifold + eikonal_weight * eikonal +
    normals_weight * SALD (``train_Point2Cyl.py:630-648``) and the three
    terms.
    """
    b, k, s, _ = sk_pts.shape
    m = b * k
    pts = sk_pts.reshape(m, s, 2)
    lat = latents.reshape(m, -1)
    normals = sk_normals.reshape(m, s, 2)
    if off_pts is None:
        off_pts = sample_off_surface(generator, pts)

    if chunk_size is None or chunk_size >= m:
        per = _per_instance(decoder, pts, lat, normals, off_pts)
    else:
        c = max(int(chunk_size), 1)
        while m % c:  # the largest divisor of M not above the request
            c -= 1
        params = tuple(decoder.parameters())
        per = torch.cat([
            _RecomputedChunk.apply(decoder, pts[i:i + c], lat[i:i + c], normals[i:i + c],
                                   off_pts[i:i + c], *params)
            for i in range(0, m, c)], dim=1)

    mnfld, eik, sald = (reduce_mean_masked_instance(t.reshape(b, k), mask_gt).mean()
                        for t in per)
    total = mnfld + eikonal_weight * eik + normals_weight * sald
    return IGRLosses(total, mnfld, eik, sald)


def latent_loss(latents: torch.Tensor, latents_gt: torch.Tensor,
                mask_gt: torch.Tensor, use_l2: bool = True) -> torch.Tensor:
    """Predicted-vs-GT latent loss, squared L2 or 1 - dot (the latents are
    unit norm, so the dot is the cosine; ``train_Point2Cyl.py:657-672``).

    Args: latents, latents_gt (B, K, L); mask_gt (B, K).
    """
    if use_l2:
        per = ((latents - latents_gt) ** 2).sum(-1)
    else:
        per = 1.0 - (latents * latents_gt).sum(-1)
    return reduce_mean_masked_instance(per, mask_gt).mean()
