"""The collectives of frequency parallelism, as differentiable functions
over a mesh's freq group.

JAX shards IPDnet2 over frequency by constraining its features to
``P('data', None, 'freq', None)``; XLA's SPMD partitioner then inserts
every collective. Torch has no partitioner, so the model calls these
where its forward crosses frequency (``SpatialNet.forward(x,
freq_mesh=mesh)``):

  ``FreqShard.halo``    the grouped frequency conv's halo: (k-1)/2 bins
                        from the left, k/2 from the right, zeros at the
                        global edges only. A halo may be wider than a
                        shard and then reaches past the neighbour;
  ``FreqShard.gather``  the whole frequency axis, for the full-band Linear,
                        for a pool whose windows straddle shards (the rest
                        of the net then runs replicated on every freq rank)
                        and for the output.

Gradients: every freq rank computes the same loss from the gathered
output, and each gather's backward is the adjoint of a gather, a
reduce-scatter SUM. A rank's gradients are then those of the sum of the
freq ranks' (equal) losses: a parameter used on the rank's shard collects
n_freq times its share, one used after a gather its whole gradient, so the
mean over the mesh's whole world (``average_gradients``) is the
single-process gradient of the global batch's loss.

The collectives are ``all_gather`` and ``all_reduce``, which gloo and NCCL
both take. A gloo group takes CPU tensors (the card's tensors are staged
through the host); a NCCL group takes the card's. The reduce-scatter is an
``all_reduce`` of the whole gradient, sliced: n_freq times the bytes of a
reduce-scatter, and on every backend. ``TRAFFIC`` counts the bytes each
collective moves on this rank (the size of the buffer it gathers into or
reduces) and the calls.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from fnssl_tpu_torch.parallel.distributed import _comm_device

TRAFFIC = {"bytes": 0, "calls": 0}


def reset_traffic() -> None:
    TRAFFIC.update(bytes=0, calls=0)


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` (equal shapes), in the group's rank order, on
    ``x``'s device."""
    comm = x.detach().to(_comm_device()).contiguous()
    parts = [torch.empty_like(comm) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, comm, group=group)
    TRAFFIC["bytes"] += comm.numel() * comm.element_size() * len(parts)
    TRAFFIC["calls"] += 1
    return [p.to(x.device) for p in parts]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group, on ``x``'s device."""
    comm = x.detach().to(_comm_device(), copy=True).contiguous()
    dist.all_reduce(comm, group=group)
    TRAFFIC["bytes"] += comm.numel() * comm.element_size()
    TRAFFIC["calls"] += 1
    return comm.to(x.device)


class _Gather(torch.autograd.Function):
    """All shards of ``x`` along ``dim``; backward: the gradient summed
    over the group, this rank's block (a reduce-scatter SUM)."""

    @staticmethod
    def forward(ctx, x, dim, group, index):
        ctx.dim, ctx.group, ctx.index, ctx.n = dim, group, index, x.shape[dim]
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


def _halo_plan(index: int, size: int, n: int, left: int, right: int):
    """Where the halo bins of shard ``index`` (of ``size`` shards of ``n``
    bins) come from. Every shard contributes its edges, its first
    min(right, n) bins (head) then its last min(left, n) (tail), e = head
    + tail bins; the concatenated edges of all shards hold every bin a
    halo needs. Returns (zeros on the left, flat edge indices of the left
    halo, flat edge indices of the right halo, zeros on the right, head,
    tail)."""
    head, tail = min(right, n), min(left, n)
    e, total, start = head + tail, size * n, index * n
    lefts = [g for g in range(start - left, start) if g >= 0]
    rights = [g for g in range(start + n, start + n + right) if g < total]
    # bin g of shard q = g // n sits at offset g - q·n; a left halo bin is
    # in its shard's tail, a right halo bin in its head
    li = [(g // n) * e + head + (g % n) - (n - tail) for g in lefts]
    ri = [(g // n) * e + g % n for g in rights]
    return left - len(lefts), li, ri, right - len(rights), head, tail


class _Halo(torch.autograd.Function):
    """x (..., n) → (..., left + n + right): the neighbours' bins on
    either side, zeros beyond the global edges."""

    @staticmethod
    def forward(ctx, x, left, right, group, index):
        size, n = dist.get_world_size(group), x.shape[-1]
        zl, li, ri, zr, head, tail = _halo_plan(index, size, n, left, right)
        edges = torch.cat(_all_gather(
            torch.cat([x[..., :head], x[..., n - tail:]], -1), group), -1)
        ctx.plan, ctx.group, ctx.index, ctx.n = (li, ri, head, tail), group, \
            index, n
        ctx.left, ctx.edges = left, edges.shape
        li_t = torch.tensor(li, dtype=torch.long, device=x.device)
        ri_t = torch.tensor(ri, dtype=torch.long, device=x.device)
        zeros = x.new_zeros(x.shape[:-1] + (zl,))
        return torch.cat([zeros, edges.index_select(-1, li_t), x,
                          edges.index_select(-1, ri_t),
                          x.new_zeros(x.shape[:-1] + (zr,))], -1)

    @staticmethod
    def backward(ctx, g):
        li, ri, head, tail = ctx.plan
        n, left = ctx.n, ctx.left
        zl = left - len(li)
        idx = torch.tensor(li + ri, dtype=torch.long, device=g.device)
        halo = torch.cat([g[..., zl:left],
                          g[..., left + n:left + n + len(ri)]], -1)
        flat = g.new_zeros(ctx.edges).index_add_(-1, idx, halo)
        flat = _all_reduce(flat, ctx.group)
        mine = flat[..., ctx.index * (head + tail):
                    (ctx.index + 1) * (head + tail)]
        dx = g[..., left:left + n].clone()
        dx[..., :head] += mine[..., :head]
        dx[..., n - tail:] += mine[..., head:]
        return dx, None, None, None, None


class FreqShard:
    """This rank's shard of the frequency axis: its index among the
    ``size`` ranks of the mesh's freq group. None for a mesh without a
    freq axis to split (``of``)."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size

    @classmethod
    def of(cls, mesh) -> "FreqShard | None":
        if mesh is None or mesh.n_freq == 1:
            return None
        return cls(mesh.freq_group, mesh.freq_index, mesh.n_freq)

    def block(self, n_local: int) -> slice:
        """This rank's bins of an axis split into shards of ``n_local``."""
        return slice(self.index * n_local, (self.index + 1) * n_local)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, dim % x.dim(), self.group, self.index)

    def halo(self, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
        return _Halo.apply(x, left, right, self.group, self.index)


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Every parameter's gradient replaced by its mean over the process
    group's world (one flat all-reduce); a no-op without a group. A
    parameter without a gradient counts as zero on that rank."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    buf = flat.to(_comm_device(), copy=True)
    dist.all_reduce(buf)
    buf = buf.to(flat.device) / dist.get_world_size()
    offset = 0
    for p in params:
        p.grad.copy_(buf[offset:offset + p.numel()].view_as(p.grad))
        offset += p.numel()
