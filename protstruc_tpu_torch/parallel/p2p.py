"""Differentiable point-to-point exchanges for the ring (``ops/ring_attn.py``)
and the pipeline (``parallel/pipeline.py``).

``torch.distributed``'s send and receive carry no gradient; JAX gets the
transposed ``ppermute`` for free.  Here a rotation is a pair of autograd
functions: :func:`post_rotation` posts ``batch_isend_irecv`` (send to ``to``,
receive from ``frm``) and returns the pending receive buffer, so that the
caller works while the bytes move, and :func:`finish_rotation` waits for it.
Their backwards run the same exchange the other way (the cotangent of the
received tensor goes back to its sender, the cotangent of the sent tensor
comes home), posted by the backward of the wait and waited for by the
backward of the post.  Every rank must issue its exchanges in the same
order; each exchange has its own tag (gloo matches messages by tag, NCCL by
order).

:func:`replicate_sum` is the pipeline's ``psum``: an all-reduce whose
backward passes the cotangent through, since every rank holds the cotangent
of the same replicated value.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["post_rotation", "finish_rotation", "replicate_sum"]


class _Exchange:
    """One exchange: send to ``to``, receive from ``frm`` (global ranks) under
    ``tag``; reversed (to and frm swapped) under ``tag + 1``."""

    def __init__(self, group, to: int, frm: int, tag: int):
        self.group, self.to, self.frm, self.tag = group, to, frm, tag
        self.works = None

    def post(self, x, reverse: bool = False):
        to, frm = (self.frm, self.to) if reverse else (self.to, self.frm)
        tag = self.tag + int(reverse)
        buf = torch.empty_like(x)
        self.works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, to, self.group, tag),
            dist.P2POp(dist.irecv, buf, frm, self.group, tag)])
        return buf

    def wait(self):
        for w in self.works:
            w.wait()
        self.works = None


class _Post(torch.autograd.Function):
    """Posts the exchange of ``x`` and returns the pending receive buffer.
    Backward: waits for the reverse exchange :class:`_Wait`'s backward
    posted and returns the cotangent that came home."""

    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return ex.post(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        ctx.ex.wait()
        return g, None


class _Wait(torch.autograd.Function):
    """Waits for the exchange :class:`_Post` posted.  Backward: posts the
    exchange of the cotangent the other way."""

    @staticmethod
    def forward(ctx, buf, ex):
        ctx.ex = ex
        ex.wait()
        return buf.view_as(buf)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.post(g.contiguous(), reverse=True), None


class _Pending:
    """A posted rotation: the receive buffer and its exchange."""

    def __init__(self, buf, ex):
        self.buf, self.ex = buf, ex


def post_rotation(x: torch.Tensor, group, to: int, frm: int, tag: int) -> _Pending:
    """Post the exchange of ``x`` (send to global rank ``to``, receive the
    same shape from ``frm``); finish it with :func:`finish_rotation`."""
    ex = _Exchange(group, to, frm, tag)
    return _Pending(_Post.apply(x, ex), ex)


def finish_rotation(pending: _Pending) -> torch.Tensor:
    """Wait for a posted exchange; returns the received tensor."""
    return _Wait.apply(pending.buf, pending.ex)


class _ReplicateSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicate_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, on every rank; its backward
    hands each rank's cotangent (that of the one replicated value) straight
    to its ``x``."""
    return _ReplicateSum.apply(x, group)
