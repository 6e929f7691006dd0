"""H-sharded spatial parallelism, DP x SP (port of
``ebfi_tpu/parallel/mesh.py::spatial_shardings`` and of the halo exchanges
that XLA's SPMD partitioner inserts into the JAX package's spatial step).

The R processes form a D x S grid with the model axis fastest: rank
``d * S + m`` is band ``m`` of data shard ``d`` (``make_mesh``'s
``devices.reshape(n // mp, mp)``).  The S ranks of a data shard (its
model group) hold the same whole items; each computes the model on its
band of ``H / S`` rows, rank ``m`` on rows ``[m * H / S, (m + 1) * H / S)``.

Inside :func:`band_scope` the row-coupled ops of the port read their
band from :func:`current_band`: a conv takes its halo rows from the
neighbouring bands (:func:`halo_rows`) and pads only the image's own
edges; a norm's or a mean's statistics sum over the model group
(:func:`model_sum`).  Outside a scope every op computes what it computes
without this module, through the same calls.

Which loss each rank's backward sees: the whole image's, but only
through its own band.  The train step gathers the two heads over the
model group (:func:`gather_rows`), whose backward hands each rank its
band's rows of the gradient, so the ranks' parameter gradients sum,
over the model group, to the loss's.  Every collective's backward is
consistent with that: :func:`model_sum`'s sums its ranks' upstream
gradients, and :func:`halo_rows`'s adds each halo row's gradient into
the rows of the rank that owns it.  The Updater then sums the gradients
over the model axis and averages them over the data axis: one all-reduce
over the world, divided by D.

Transport, chosen by the backend: the halos and the gathered heads travel
by ``all_gather`` over the model group; under gloo through explicit host
copies (gloo runs its collectives on the host; its point-to-point ops do
not take a CUDA tensor), under NCCL on the card.  Other backends raise.
The statistics' sums are ``all_reduce`` on the tensors' device, as the
data-parallel gradients' are.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .dist import all_reduce_sum

BAND_ALIGN = 8  # the model's /8 grid: every stride of the trunk and the detail branch
TRANSPORTS = ("gloo", "nccl")


class SpatialSpec:
    """This rank's place in the D x S grid: ``data`` (D) and ``model`` (S),
    the axes' sizes; ``data_index`` and ``band_index``; ``model_group``
    (the S ranks of this data shard) and ``data_group`` (the D ranks of
    this band), both None without a process group; ``backend``."""

    def __init__(self, data: int, model: int, rank: int, model_group=None, data_group=None,
                 backend: Optional[str] = None):
        self.data, self.model = data, model
        self.data_index, self.band_index = divmod(rank, model)
        self.model_group, self.data_group = model_group, data_group
        self.backend = backend

    @property
    def first(self) -> bool:
        return self.band_index == 0

    @property
    def last(self) -> bool:
        return self.band_index == self.model - 1

    def check_rows(self, rows: int) -> None:
        """Raise unless ``rows`` (the whole image's H) splits into S bands
        aligned to BAND_ALIGN."""
        if rows % (BAND_ALIGN * self.model):
            raise ValueError(
                f"spatial parallelism: H = {rows} rows is not a multiple of the band alignment "
                f"{BAND_ALIGN} x the model axis {self.model} (= {BAND_ALIGN * self.model})")

    def band_rows(self, rows: int) -> Tuple[int, int]:
        """[start, stop) of this rank's band of an image of ``rows`` rows."""
        self.check_rows(rows)
        n = rows // self.model
        return self.band_index * n, (self.band_index + 1) * n

    def __repr__(self) -> str:
        return (f"SpatialSpec(data={self.data}, model={self.model}, "
                f"data_index={self.data_index}, band_index={self.band_index})")


def spatial_shardings(model_parallel: int) -> SpatialSpec:
    """Split the process group into a (world / model_parallel) x
    model_parallel grid and return this rank's :class:`SpatialSpec`.
    Every rank calls it, once, after
    :func:`~ebfi_tpu_torch.parallel.maybe_init_distributed`: it creates
    every model group and every data group (``dist.new_group``) in the same
    order on every rank.  Without a process group it is the grid of one
    process, and ``model_parallel`` must be 1."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError(f"model_parallel={model_parallel} needs a process group of "
                             f"{model_parallel} or a multiple of it; none is initialized")
        return SpatialSpec(1, 1, 0)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_parallel:
        raise ValueError(f"{world} processes not divisible by model_parallel={model_parallel}")
    backend = dist.get_backend()
    if backend not in TRANSPORTS:
        raise ValueError(f"spatial parallelism has no halo transport for backend {backend!r} "
                         f"(it has {TRANSPORTS})")
    data, model = world // model_parallel, model_parallel
    model_group = data_group = None
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    return SpatialSpec(data, model, rank, model_group, data_group, backend)


# ---------------------------------------------------------------- the band scope

_BAND: ContextVar[Optional[SpatialSpec]] = ContextVar("ebfi_spatial_band", default=None)


@contextmanager
def band_scope(spec: SpatialSpec):
    """Within it, the port's row-coupled ops run on ``spec``'s band."""
    token = _BAND.set(spec)
    try:
        yield spec
    finally:
        _BAND.reset(token)


def current_band() -> Optional[SpatialSpec]:
    """The band the ops run on, or None outside :func:`band_scope`."""
    return _BAND.get()


# ---------------------------------------------------------------- collectives


def _gather(t: torch.Tensor, spec: SpatialSpec) -> List[torch.Tensor]:
    """``t`` of every rank of the model group, in band order, bit for bit
    (the bytes travel, whatever the dtype: gloo gathers no 16-bit integer)."""
    wire = t.detach().contiguous().view(torch.uint8)
    if spec.backend == "gloo":
        wire = wire.cpu()
    elif spec.backend != "nccl":
        raise ValueError(f"no halo transport for backend {spec.backend!r}")
    parts = [torch.empty_like(wire) for _ in range(spec.model)]
    dist.all_gather(parts, wire, group=spec.model_group)
    return [p.to(t.device).view(t.dtype) for p in parts]


Edge = Union[str, float]  # "zeros", "replicate", "reflect" (REFLECT_101) or a constant


def _edge_rows(x: torch.Tensor, dim: int, n: int, top: bool, edge: Edge) -> torch.Tensor:
    """The ``n`` rows that pad the image's own top (or bottom) edge."""
    rows = x.shape[dim]
    if edge == "replicate":
        size = list(x.shape)
        size[dim] = n
        return x.narrow(dim, 0 if top else rows - 1, 1).expand(size)
    if edge == "reflect":  # row -i is row i; row rows-1+i is row rows-1-i
        return x.narrow(dim, 1 if top else rows - 1 - n, n).flip(dim)
    shape = list(x.shape)
    shape[dim] = n
    return x.new_full(shape, 0.0 if edge == "zeros" else float(edge))


def _edge_grad_(gx: torch.Tensor, g: torch.Tensor, dim: int, top: bool, edge: Edge) -> None:
    """Add the gradient ``g`` of the edge rows into the rows they copy."""
    rows, n = gx.shape[dim], g.shape[dim]
    if edge == "replicate":
        gx.narrow(dim, 0 if top else rows - 1, 1).add_(g.sum(dim, keepdim=True))
    elif edge == "reflect":
        gx.narrow(dim, 1 if top else rows - 1 - n, n).add_(g.flip(dim))


class _HaloRows(torch.autograd.Function):
    """cat([up rows above, x, down rows below], dim): the rows of the
    neighbouring bands, and at the image's own edges the ``edge`` padding.
    The backward adds each halo row's gradient into its owner's rows (and
    an edge row's into the rows it copies)."""

    @staticmethod
    def forward(ctx, x, dim, up, down, edge, spec):
        ctx.dim, ctx.up, ctx.down, ctx.edge, ctx.spec = dim, up, down, edge, spec
        rows = x.shape[dim]
        if spec.model > 1:
            # what the neighbours take: my top `down` rows and my bottom `up` rows
            parts = _gather(torch.cat([x.narrow(dim, 0, down), x.narrow(dim, rows - up, up)],
                                      dim), spec)
        m = spec.band_index
        top = (_edge_rows(x, dim, up, True, edge) if spec.first
               else parts[m - 1].narrow(dim, down, up))
        bottom = (_edge_rows(x, dim, down, False, edge) if spec.last
                  else parts[m + 1].narrow(dim, 0, down))
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, grad):
        dim, up, down, edge, spec = ctx.dim, ctx.up, ctx.down, ctx.edge, ctx.spec
        rows = grad.shape[dim] - up - down
        g_top, g_bottom = grad.narrow(dim, 0, up), grad.narrow(dim, up + rows, down)
        gx = grad.narrow(dim, up, rows).clone(memory_format=torch.contiguous_format)
        m = spec.band_index
        if spec.model > 1:
            parts = _gather(torch.cat([g_top, g_bottom], dim), spec)
            if not spec.first:  # my top rows were the band above's bottom halo
                gx.narrow(dim, 0, down).add_(parts[m - 1].narrow(dim, up, down))
            if not spec.last:  # my bottom rows were the band below's top halo
                gx.narrow(dim, rows - up, up).add_(parts[m + 1].narrow(dim, 0, up))
        if spec.first:
            _edge_grad_(gx, g_top, dim, True, edge)
        if spec.last:
            _edge_grad_(gx, g_bottom, dim, False, edge)
        return gx, None, None, None, None, None


def halo_rows(x: torch.Tensor, dim: int, up: int, down: int, edge: Edge = "zeros") -> torch.Tensor:
    """x's band (of the current band scope) with ``up`` rows above and
    ``down`` below along ``dim``: the neighbouring bands' rows, and at the
    image's own top and bottom ``edge``: "zeros", "replicate", "reflect"
    (REFLECT_101, torch's "reflect") or a constant.  Differentiable.
    Every rank of the model group calls it at the same point; a band
    shorter than a halo raises."""
    if up == 0 and down == 0:
        return x
    if max(up, down) > x.shape[dim] or (edge == "reflect" and max(up, down) >= x.shape[dim]):
        raise ValueError(f"spatial parallelism: a band of {x.shape[dim]} rows is shorter than "
                         f"its halo ({up} above, {down} below): use fewer bands or taller images")
    return _HaloRows.apply(x, dim, up, down, edge, current_band())


def model_sum(x: torch.Tensor, spec: Optional[SpatialSpec] = None) -> torch.Tensor:
    """``x`` summed over the model group, differentiable (the statistics of
    the whole image from the bands' partial sums)."""
    spec = spec or current_band()
    if spec.model == 1:
        return x
    return all_reduce_sum(x, spec.model_group)


def band_mean(x: torch.Tensor, dims: Sequence[int], keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dims)`` over the whole image, with the band's rows among
    ``dims``: the sum in f32 over the model group, divided by the whole
    count, in x's dtype.  Outside a band scope: ``x.mean(dims)``."""
    spec = current_band()
    if spec is None:
        return x.mean(dim=tuple(dims), keepdim=keepdim)
    count = spec.model
    for d in dims:
        count *= x.shape[d]
    return (model_sum(x.float().sum(dim=tuple(dims), keepdim=keepdim), spec) / count).to(x.dtype)


class _GatherRows(torch.autograd.Function):
    """The bands of the model group concatenated along ``dim``; the
    backward hands each rank its own band's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, spec):
        ctx.dim, ctx.spec, ctx.rows = dim, spec, x.shape[dim]
        return torch.cat(_gather(x, spec), dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.spec.band_index * ctx.rows
        return grad.narrow(ctx.dim, start, ctx.rows), None, None


def gather_rows(x: torch.Tensor, spec: SpatialSpec, dim: int = 1) -> torch.Tensor:
    """The whole image from the bands of the model group (see the module's
    docstring for the backward's scale)."""
    if spec.model == 1:
        return x
    return _GatherRows.apply(x, dim, spec)
