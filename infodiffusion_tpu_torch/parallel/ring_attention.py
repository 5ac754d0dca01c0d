"""Ring attention over the ranks of a ``seq`` group
(JAX counterpart: ``infodiffusion_tpu/parallel/ring_attention.py``).

``softmax(q k^T / sqrt(C)) v`` with the tokens split over S ranks: rank
``r`` takes the query block ``r`` ([B, N/S, C]) of the whole q, k and v
it holds (the model is replicated under ``--sp``), and the K/V blocks
travel around the ring with point-to-point sends (``batch_isend_irecv``,
rank r to r + 1), while the rank accumulates its queries' output with the
running log-sum-exp in f32 (plain torch products, as the JAX ring's
einsums: no kernel). The own block comes first, then r - 1, r - 2, ...,
the JAX ring's order. No rank holds more than one [B, N/S, N/S] block of
logits.

The op's boundary is replicated, as JAX pins it: the output blocks are
all-gathered to every rank, and the backward, given the whole cotangent
(the same on every rank), runs the ring again with the dK/dV
accumulators travelling beside their blocks (S hops bring each back to its
owner) and all-gathers dQ, dK and dV whole. Each rank thus returns the
one-process gradient, and nothing downstream is counted S times.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from infodiffusion_tpu_torch.parallel.mesh import SEQ_AXIS, make_1d_mesh


def make_seq_mesh(n_shards: int):
    return make_1d_mesh(n_shards, SEQ_AXIS)


def _rotate(t: torch.Tensor, group) -> torch.Tensor:
    """Send ``t`` to the next rank of the ring, receive the previous
    rank's."""
    S, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % S)
    prv = dist.get_global_rank(group, (r - 1) % S)
    t = t.contiguous()
    buf = torch.empty_like(t)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, nxt, group),
            dist.P2POp(dist.irecv, buf, prv, group)]):
        req.wait()
    return buf


def _gather_tokens(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, 1)


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group):
        S, r = dist.get_world_size(group), dist.get_rank(group)
        n = q.shape[1] // S
        sl = slice(r * n, (r + 1) * n)
        scale = q.shape[-1] ** -0.5
        f32 = torch.float32
        qf = q[:, sl].to(f32)
        kv = torch.stack([k[:, sl].to(f32), v[:, sl].to(f32)])
        B = q.shape[0]
        m = torch.full((B, n, 1), float("-inf"), dtype=f32, device=q.device)
        l = torch.zeros((B, n, 1), dtype=f32, device=q.device)
        o = torch.zeros((B, n, q.shape[-1]), dtype=f32, device=q.device)
        for i in range(S):
            if i:
                kv = _rotate(kv, group)
            logits = torch.bmm(qf, kv[0].transpose(1, 2)) * scale
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + torch.bmm(p, kv[1])
            m = m_new
        o = o / l
        ctx.group, ctx.sl, ctx.scale = group, sl, scale
        ctx.save_for_backward(q[:, sl], k[:, sl], v[:, sl], o, m + torch.log(l))
        return _gather_tokens(o.to(v.dtype), group)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, scale, f32 = ctx.group, ctx.scale, torch.float32
        S = dist.get_world_size(group)
        qf = q.to(f32)
        dof = do[:, ctx.sl].to(f32)
        D = (dof * o).sum(-1, keepdim=True)
        dq = torch.zeros_like(qf)
        # a K/V block and its dK/dV accumulators travel together
        blk = torch.stack([k.to(f32), v.to(f32), torch.zeros_like(qf),
                           torch.zeros_like(qf)])
        for i in range(S):
            if i:
                blk = _rotate(blk, group)
            kc, vc, dk, dv = blk.unbind(0)
            p = torch.exp(torch.bmm(qf, kc.transpose(1, 2)) * scale - lse)
            dv = dv + torch.bmm(p.transpose(1, 2), dof)
            ds = p * (torch.bmm(dof, vc.transpose(1, 2)) - D)
            dq = dq + torch.bmm(ds, kc) * scale
            dk = dk + torch.bmm(ds.transpose(1, 2), qf) * scale
            blk = torch.stack([kc, vc, dk, dv])
        blk = _rotate(blk[2:], group)  # the last hop home
        return (_gather_tokens(dq, group).to(q.dtype),
                _gather_tokens(blk[0], group).to(k.dtype),
                _gather_tokens(blk[1], group).to(v.dtype), None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group) -> torch.Tensor:
    """q, k, v: [B, N, C], the same on every rank of ``group`` (N divisible
    by its size) -> [B, N, C] on every rank, equal to
    ``ops.attention.single_head_attention`` up to f32 reassociation."""
    S = dist.get_world_size(group)
    if q.shape[1] % S:
        raise ValueError(f"{q.shape[1]} tokens do not split over {S} ranks")
    ring_attention.calls += 1
    return _Ring.apply(q, k, v, group)


ring_attention.calls = 0  # calls of the route (tests read it)
