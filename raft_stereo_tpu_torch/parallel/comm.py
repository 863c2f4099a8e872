"""The collectives the port's parallel paths use, over ``torch.distributed``.

Each takes the grid's backend into account: NCCL takes CUDA tensors as they
are; gloo takes only host tensors, so a CUDA tensor under gloo (two ranks
sharing one card) goes through a pinned host buffer and back. That staging
is the gloo route itself, chosen by the backend the caller set up, never a
fallback from another. bf16 tensors travel as int16 bit patterns where
they are only copied (point to point, gathers): gloo reduces no bf16.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, backend: Optional[str]) -> torch.Tensor:
    """``t`` as the backend can take it: a pinned host copy for gloo and a
    CUDA tensor, else ``t`` itself (contiguous)."""
    t = t.contiguous()
    if backend == "gloo" and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _unbits(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if dtype == torch.bfloat16 else t


def all_reduce_sum_(t: torch.Tensor, backend: Optional[str], group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (the world when None), in place."""
    buf = _staged(t, backend)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


def all_reduce_sum_list_(tensors: Sequence[torch.Tensor], backend: Optional[str],
                         group=None) -> None:
    """Sum every tensor of ``tensors`` (one dtype, one device) over
    ``group``, in place, in one collective over their concatenation."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum_(flat, backend, group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_gather_cat(t: torch.Tensor, n: int, backend: Optional[str], group=None,
                   dim: int = 0) -> torch.Tensor:
    """The ``n`` ranks' ``t`` (one shape) concatenated along ``dim`` in rank
    order of ``group``, on ``t``'s device."""
    src = _staged(_bits(t), backend)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim).to(t.device)
    return _unbits(out, t.dtype)


def swap_with_neighbours(to_prev: torch.Tensor, to_next: torch.Tensor,
                         prev_rank: Optional[int], next_rank: Optional[int],
                         backend: Optional[str], group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``to_prev`` to the global rank ``prev_rank`` and ``to_next`` to
    ``next_rank``; return ``(from_prev, from_next)``, what they sent here,
    zeros where there is no neighbour (None). All four transfers are posted
    at once, so the exchange cannot deadlock on its order."""
    from_prev = torch.zeros_like(to_prev)
    from_next = torch.zeros_like(to_next)
    ops: List[dist.P2POp] = []
    recv: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for peer, out, back in ((prev_rank, to_prev, from_prev), (next_rank, to_next, from_next)):
        if peer is None:
            continue
        send = _staged(_bits(out), backend)
        got = _staged(_bits(torch.empty_like(back)), backend)
        ops.append(dist.P2POp(dist.isend, send, peer, group))
        ops.append(dist.P2POp(dist.irecv, got, peer, group))
        recv.append((back, got))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for back, got in recv:
            back.copy_(_unbits(got, back.dtype))
    return from_prev, from_next


def any_rank(flag: bool, backend: Optional[str], device: torch.device) -> bool:
    """Whether ``flag`` is set on any rank of the world (the ranks' flags
    summed)."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce_sum_(t, backend).item() > 0)
