"""Gradient all-reduce in the backward pass (counterpart of
``tpupt/diff/overlap.py``).

``psum_in_backward(tree, group)`` is an identity on the float tensors of
``tree`` that require grad; in the backward pass it sums their cotangents
over the ``torch.distributed`` process group ``group``, so that a scene
replicated on every rank gets the gradient of the sum of the ranks'
losses.  The sum is linear, so reducing each bounce's cotangent where it
is produced (one node per bounce, the integrator's
``grad_psum_overlap=True``) gives the gradient that one reduction of the
summed cotangent gives (one node before the bounce loop, post-hoc), up
to the order of float additions.

The backward flattens the node's cotangents into one buffer, all-reduces
it and hands the sums on to autograd.  The collective is ordered with
the backward's compute: on NCCL the compute after it waits for it on the
card, so the per-bounce placement does not overlap its collectives with
the backward sweep as the JAX package's scheduler can.  It is kept for
the JAX package's interface; post-hoc makes one collective a sample
instead of one a bounce.

Every rank must run the same sequence of these nodes: a rank that skipped
a bounce would leave the others waiting in a collective.  The JAX
package's ``pcast``/varying-manual-axes bookkeeping has no counterpart:
``torch.distributed`` programs are per rank, with no type of device
variance to keep.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


class _PsumInBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # autograd hands zeros for the outputs that got no cotangent (which
        # ones do depends on the band: a band that dies at its first bounce
        # never reaches some leaves), so every rank sends the same layout
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=ctx.group)
        pieces = torch.split(flat, [g.numel() for g in gs])
        return (None, *(p.view(g.shape) for p, g in zip(pieces, gs)))


def _routed(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point() and x.requires_grad


def _collect(tree, out):
    if _routed(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _collect(v, out)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _collect(getattr(tree, f.name), out)


def _rebuild(tree, it):
    if _routed(tree):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), it)
                                            for f in dataclasses.fields(tree)})
    return tree


def psum_in_backward(tree, group):
    """Identity on ``tree`` (a tensor, a dict or a dataclass such as
    ``SceneArrays``, nested); in reverse mode, the cotangents of its float
    tensors that require grad are summed over the process group ``group``
    where this node sits in the graph."""
    xs = []
    _collect(tree, xs)
    if not xs:
        return tree
    return _rebuild(tree, iter(_PsumInBackward.apply(group, *xs)))
