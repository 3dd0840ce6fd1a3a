"""Collectives along named mesh axes, and the ranks that run them.

This module has no counterpart file in the reference. There one program
drives every device of a mesh: GSPMD inserts the collectives that a
sharding implies, and ``shard_map`` code names them (``jax.lax.psum``,
``pmax``, ``all_gather``, ``ppermute``, ``axis_index``). In PyTorch each
rank is a process that holds its own shards and calls the collectives
itself, through `torch.distributed`:

- `Comm` is one rank's view of a `repro_torch.launch.mesh.Mesh`: its
  coordinates, its device, and one process group per set of axes (every
  slice of the other axes gets its own), built once after
  ``init_process_group``. Its collectives take an axis name or a tuple of
  them: `all_reduce` (sum, max), `all_gather`, `reduce_scatter`,
  `ring_permute`, `copy_to` and `gather` (to one rank). A collective
  over axes of size 1 is the identity.
- Autograd: `all_gather`'s backward reduce-scatters the cotangent (each
  rank's is a partial sum, as for a gathered parameter), or with
  ``grad="slice"`` keeps this rank's piece of it (each rank's is whole,
  as for an activation used replicated after the gather); `all_reduce`
  (sum) passes its cotangent through, since every rank differentiates
  its own copy of the replicated result; `copy_to`, its conjugate, is the
  identity forward and all-reduces the cotangent backward (Megatron's
  copy to the model-parallel region: the input of a product whose
  columns are split over the axis); `ring_permute`
  sends to ``(i + 1) % n`` and receives from ``(i - 1) % n``, and its
  backward sends the cotangent the other way, as jax transposes
  ``ppermute``. `reduce_scatter` carries no gradient (it reduces
  gradients).
- The transport is an argument, never chosen silently. ``"nccl"`` needs
  one card per rank and raises, naming ``"gloo"``, where there are fewer;
  NCCL refuses two ranks on one card. ``"gloo"`` moves CPU tensors; a
  CUDA payload is copied to the host, exchanged and copied back here,
  explicitly (`_to_wire` / `_from_wire`), while all compute stays on the
  rank's device. NCCL moves CUDA tensors; a host payload goes to the
  rank's card and back the same way.
- Bytes moved per collective kind are counted on the `Comm` (``.bytes``)
  and as ``comm.<kind>_bytes`` `repro_torch.obs` counters.
- `DryComm` is a rank that moves nothing (no process group): its
  collectives return tensors of the right shape and count their bytes,
  so one rank's step runs on fake tensors (`repro_torch.launch.dryrun`).

`run_ranks` spawns one process per mesh position (start method
``spawn``: the parent may have initialised CUDA) over a ``file://`` store
in a temporary directory, builds the CUDA kernels once in the parent
first, and returns what each rank's function returned, with its kernel
launches, peak device memory and bytes moved. A rank that raises, or a
run that outlasts its timeout, fails the whole run: a hang in a
collective ends as a `TimeoutError`, not a wait.
"""

from __future__ import annotations

import collections
import datetime
import itertools
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs
from ..device import resolve_device

BACKENDS = ("nccl", "gloo")
# torch 2.13 renamed the tensor forms of these two collectives (the old
# names still work there, with a warning); older releases have only the old.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def check_transport(backend: str, device: str, n_ranks: int) -> None:
    """Raise unless ``backend`` can carry ``n_ranks`` ranks on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"dist backend {backend!r}: use one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend moves CUDA tensors: use backend='gloo' with "
                             "device='cpu'")
        if torch.cuda.device_count() < n_ranks:
            raise RuntimeError(
                f"nccl needs one card per rank: {n_ranks} ranks, "
                f"{torch.cuda.device_count()} card(s); NCCL refuses two ranks on one card. "
                "Pass --dist-backend gloo to stage each payload through host memory")


def _axes(mesh, axis) -> Tuple[str, ...]:
    """``axis`` (a name or names) in mesh order, axes of size 1 dropped."""
    names = (axis,) if isinstance(axis, str) else tuple(axis or ())
    for a in names:
        if a not in mesh.shape:
            raise ValueError(f"no axis {a!r} in {mesh}")
    return tuple(a for a in mesh.axis_names if a in names and mesh.shape[a] > 1)


def _slices(mesh, axes: Tuple[str, ...]) -> List[List[int]]:
    """The ranks of every slice of ``mesh`` along ``axes``, each slice
    ascending in its own row-major order."""
    ranks = np.arange(mesh.size).reshape(tuple(mesh.shape.values()))
    keep = [mesh.axis_names.index(a) for a in axes]
    rest = [d for d in range(ranks.ndim) if d not in keep]
    n = int(np.prod([mesh.shape[a] for a in axes]))
    return ranks.transpose(rest + keep).reshape(-1, n).tolist()


class Comm:
    """One rank of a mesh: its coordinates, device and process groups. The
    transport is named (``backend``, no default) and the device is the
    card unless ``device="cpu"``, as for every entry point."""

    def __init__(self, mesh, rank: int, *, backend: str, device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"dist backend {backend!r}: use one of {BACKENDS}")
        self.mesh = mesh
        self.rank = rank
        self.backend = backend
        self.device = resolve_device(device)
        self.coords = mesh.coords(rank)
        self.bytes: Dict[str, int] = collections.Counter()
        self._groups: Dict[Tuple[str, ...], Tuple[Any, List[int]]] = {}
        if mesh.size > 1:
            self._build_groups()

    def _build_groups(self) -> None:
        """Every rank creates every group, in one order (a collective)."""
        live = [a for a in self.mesh.axis_names if self.mesh.shape[a] > 1]
        for k in range(1, len(live) + 1):
            for axes in itertools.combinations(live, k):
                for members in _slices(self.mesh, axes):
                    group = (dist.group.WORLD if len(members) == self.mesh.size
                             else dist.new_group(members))
                    if self.rank in members:
                        self._groups[axes] = (group, members)

    # ------------------------------------------------------------- helpers

    def axis_size(self, axis) -> int:
        n = 1
        for a in (axis,) if isinstance(axis, str) else tuple(axis or ()):
            n *= self.mesh.shape[a]
        return n

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (names: row-major over them)."""
        i = 0
        for a in (axis,) if isinstance(axis, str) else tuple(axis or ()):
            i = i * self.mesh.shape[a] + self.coords[a]
        return i

    def _group(self, axis):
        axes = _axes(self.mesh, axis)
        return self._groups[axes] if axes else (None, [self.rank])

    def _count(self, kind: str, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self.bytes[kind] += n
        obs.add(f"comm.{kind}_bytes", n)

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy the transport can move: gloo moves host
        memory, NCCL the rank's card (a host payload, such as served
        tokens, goes over and comes back)."""
        if self.backend == "gloo" and t.is_cuda:
            return t.detach().to("cpu", copy=True).contiguous()
        if self.backend == "nccl" and not t.is_cuda:
            return t.detach().to(self.device, copy=True).contiguous()
        return t.detach().clone(memory_format=torch.contiguous_format)

    @staticmethod
    def _from_wire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device)

    # ------------------------------------------------------------- collectives

    def all_reduce(self, x: torch.Tensor, axis, op: str = "sum") -> torch.Tensor:
        """Sum (differentiable: the cotangent passes through) or max."""
        if op == "sum":
            return _AllReduceSum.apply(x, self, axis)
        if op == "max":
            return self._all_reduce(x.detach(), axis, dist.ReduceOp.MAX)
        raise ValueError(f"all_reduce op {op!r}: use 'sum' or 'max'")

    def _all_reduce(self, x, axis, op):
        group, _ = self._group(axis)
        if group is None:
            return x
        self._count("all_reduce", x)
        buf = self._to_wire(x)
        dist.all_reduce(buf, op=op, group=group)
        return self._from_wire(buf, x)

    def copy_to(self, x: torch.Tensor, axis) -> torch.Tensor:
        """``x`` itself; the backward sums the cotangent over ``axis``."""
        return _CopyTo.apply(x, self, axis)

    def all_gather(self, x: torch.Tensor, axis, dim: int = 0, *,
                   grad: str = "sum") -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in axis order. The
        backward reduce-scatters the cotangent (``grad="sum"``) or keeps
        this rank's piece of it (``grad="slice"``)."""
        if grad not in ("sum", "slice"):
            raise ValueError(f"all_gather grad {grad!r}: use 'sum' or 'slice'")
        return _AllGather.apply(x, self, axis, dim, grad)

    def gather(self, x: torch.Tensor, axis) -> Optional[List[torch.Tensor]]:
        """Every rank's ``x`` along ``axis`` on the first rank of the axis
        alone (a list in axis order, on ``x``'s device); None on the
        others. No gradient."""
        group, members = self._group(axis)
        if group is None:
            return [x]
        buf = self._to_wire(x)
        first = self.rank == members[0]
        parts = [torch.empty_like(buf) for _ in members] if first else None
        self._count("gather", buf)
        dist.gather(buf, parts, dst=members[0], group=group)
        return [self._from_wire(t, x) for t in parts] if first else None

    def _all_gather(self, x, axis, dim):
        group, members = self._group(axis)
        if group is None:
            return x
        n = len(members)
        buf = self._to_wire(x.movedim(dim, 0))
        out = torch.empty((n * buf.shape[0],) + tuple(buf.shape[1:]), dtype=buf.dtype,
                          device=buf.device)
        self._count("all_gather", out)
        _ALL_GATHER(out, buf, group=group)
        return self._from_wire(out, x).movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, axis, dim: int = 0) -> torch.Tensor:
        """The sum over the ranks of ``x``, split along ``dim``: this rank's
        piece (no gradient)."""
        group, members = self._group(axis)
        if group is None:
            return x
        n = len(members)
        buf = self._to_wire(x.detach().movedim(dim, 0))
        if buf.shape[0] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        out = torch.empty((buf.shape[0] // n,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                          device=buf.device)
        self._count("reduce_scatter", buf)
        _REDUCE_SCATTER(out, buf, group=group)
        return self._from_wire(out, x).movedim(0, dim)

    def ring_permute(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Send ``x`` to ``(i + 1) % n`` along ``axis``, return what
        ``(i - 1) % n`` sent (differentiable)."""
        return _RingPermute.apply(x, self, axis)

    def _shift(self, x, axis, step: int):
        group, members = self._group(axis)
        if group is None:
            return x
        i, n = members.index(self.rank), len(members)
        send = self._to_wire(x)
        recv = torch.empty_like(send)
        self._count("ring_permute", send)
        ops = [dist.P2POp(dist.isend, send, members[(i + step) % n], group),
               dist.P2POp(dist.irecv, recv, members[(i - step) % n], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._from_wire(recv, x)


class DryComm(Comm):
    """One rank of a mesh that moves nothing: the dry run's `Comm`
    (`repro_torch.launch.dryrun`). Every collective returns an
    uninitialised tensor of the shape the real one returns (a fake tensor
    under ``FakeTensorMode``: nothing is allocated) and counts it:
    ``bytes`` as `Comm` counts them, ``out_bytes`` as the output's bytes on
    this rank (the reference rooftool's convention; they differ for a
    reduce-scatter, whose input `Comm` counts, and a gather), ``calls`` the
    collectives by kind. No process group is made; the device is the CPU;
    the autograd Functions are `Comm`'s, so a backward's collectives count
    too."""

    def __init__(self, mesh, rank: int = 0):
        self.mesh = mesh
        self.rank = rank
        self.backend = None
        self.device = torch.device("cpu")
        self.coords = mesh.coords(rank)
        self.bytes: Dict[str, int] = collections.Counter()
        self.out_bytes: Dict[str, int] = collections.Counter()
        self.calls: Dict[str, int] = collections.Counter()
        self._groups = {}

    def _group(self, axis):
        axes = _axes(self.mesh, axis)
        if not axes:
            return None, [self.rank]
        if axes not in self._groups:
            members = next(m for m in _slices(self.mesh, axes) if self.rank in m)
            self._groups[axes] = ("dry", members)
        return self._groups[axes]

    def _tally(self, kind: str, sent: torch.Tensor, out_bytes: int) -> None:
        self.bytes[kind] += sent.numel() * sent.element_size()
        self.out_bytes[kind] += out_bytes
        self.calls[kind] += 1

    def _all_reduce(self, x, axis, op):
        if self._group(axis)[0] is None:
            return x
        self._tally("all_reduce", x, x.numel() * x.element_size())
        return torch.empty_like(x)

    def _all_gather(self, x, axis, dim):
        _, members = self._group(axis)
        if len(members) == 1:
            return x
        shape = list(x.shape)
        shape[dim] *= len(members)
        out = x.new_empty(shape)
        self._tally("all_gather", out, out.numel() * out.element_size())
        return out

    def reduce_scatter(self, x, axis, dim: int = 0):
        _, members = self._group(axis)
        if len(members) == 1:
            return x
        n = len(members)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        shape = list(x.shape)
        shape[dim] //= n
        out = x.new_empty(shape)
        self._tally("reduce_scatter", x, out.numel() * out.element_size())
        return out

    def _shift(self, x, axis, step: int):
        if self._group(axis)[0] is None:
            return x
        self._tally("ring_permute", x, x.numel() * x.element_size())
        return torch.empty_like(x)

    def gather(self, x, axis):
        _, members = self._group(axis)
        if len(members) == 1:
            return [x]
        first = self.rank == members[0]
        self._tally("gather", x, len(members) * x.numel() * x.element_size() if first else 0)
        return [torch.empty_like(x) for _ in members] if first else None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        return comm._all_reduce(x, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._all_reduce(g.contiguous(), ctx.axis, dist.ReduceOp.SUM), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, dim, grad):
        ctx.comm, ctx.axis, ctx.dim, ctx.grad = comm, axis, dim, grad
        return comm._all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        comm, axis, dim = ctx.comm, ctx.axis, ctx.dim
        if ctx.grad == "sum":
            return comm.reduce_scatter(g.contiguous(), axis, dim), None, None, None, None
        _, members = comm._group(axis)
        n = g.shape[dim] // len(members)
        return g.narrow(dim, members.index(comm.rank) * n, n), None, None, None, None


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return comm._shift(x, axis, +1)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm._shift(g.contiguous(), ctx.axis, -1), None, None


# ----------------------------------------------------------------- ranks


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class _Array:
    """A numpy array on its way to a spawned rank, as a tensor: torch.save
    writes a tensor's storage as raw bytes, where pickling the array copies
    it through the pickler, ~10x slower to write and ~20x to read
    (`tools/rank_transport.py`)."""

    def __init__(self, t: torch.Tensor):
        self.t = t


_WIRE_DTYPES = {np.dtype(t) for t in (np.float64, np.float32, np.float16, np.int64, np.int32,
                                      np.int16, np.int8, np.uint8, np.bool_)}


def _pack(tree):
    """``tree`` with each numpy array (of a dtype torch holds) as an `_Array`."""
    if isinstance(tree, np.ndarray) and tree.dtype in _WIRE_DTYPES:
        return _Array(torch.from_numpy(np.require(tree, requirements=["C", "W"])))
    if type(tree) is dict:
        return {k: _pack(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_pack(v) for v in tree)
    return tree


def _unpack(tree):
    """`_pack`'s inverse: the rank gets the numpy arrays it was given."""
    if isinstance(tree, _Array):
        return tree.t.numpy()
    if type(tree) is dict:
        return {k: _unpack(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_unpack(v) for v in tree)
    return tree


def _rank_main(rank: int, mesh, backend: str, device: str, workdir: str,
               timeout_s: float, threads: Optional[int]) -> None:
    """A spawned rank: its process group, its `Comm`, ``fn``, its record."""
    from .. import kernels

    fn, args = _unpack(torch.load(os.path.join(workdir, "job.pt"), weights_only=False))

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host: the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if resolve_device(device).type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(threads or max(1, (os.cpu_count() or 1) // mesh.size))
    dist.init_process_group(backend, init_method=f"file://{workdir}/store",
                            world_size=mesh.size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        comm = Comm(mesh, rank, backend=backend, device=dev)
        kernels.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn(comm, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record = {"result": _to_cpu(out), "rank": rank, "device": str(dev),
                  "s": time.perf_counter() - t0, "launches": kernels.launch_counts(),
                  "decode_lse_launches": kernels.decode_lse_launches(),
                  "max_memory_allocated": (int(torch.cuda.max_memory_allocated(dev))
                                           if dev.type == "cuda" else None),
                  "comm_bytes": dict(comm.bytes)}
        path = os.path.join(workdir, f"rank{rank}")
        torch.save(record, path + ".tmp")
        os.replace(path + ".tmp", path + ".pt")
    finally:
        dist.destroy_process_group()


def transport_name(backend: str, device: str, n_ranks: int) -> str:
    """How a run's ranks exchange, e.g. 'gloo, host-staged, 2 ranks on cuda:0'."""
    if resolve_device(device).type == "cpu":
        return f"{backend}, {n_ranks} ranks on cpu"
    cards = sorted({r % max(1, torch.cuda.device_count()) for r in range(n_ranks)})
    where = ", ".join(f"cuda:{c}" for c in cards)
    staged = "host-staged, " if backend == "gloo" else ""
    return f"{backend}, {staged}{n_ranks} ranks on {where}"


def run_ranks(fn: Callable, mesh, *args, backend: str, device: str = "cuda",
              timeout_s: float = 600.0, threads: Optional[int] = None) -> List[dict]:
    """Run ``fn(comm, *args)`` on one spawned process per position of
    ``mesh``; returns each rank's record in rank order: ``result`` (what
    ``fn`` returned, tensors moved to the CPU), ``launches`` (its kernel
    launches; ``decode_lse_launches``: decode's that wrote the log-sum-exp),
    ``max_memory_allocated``, ``comm_bytes`` and ``s``.

    ``fn`` and ``args`` are pickled: ``fn`` must be a module-level function
    of a module that the rank can import. ``backend`` has no default (see
    `check_transport`); the ranks compute on the card unless ``device`` is
    ``"cpu"``, each CPU rank with ``threads`` host threads (default: the
    host's cores split over the mesh; pass fewer where other spawns run at
    the same time). Raises what a rank raised, or `TimeoutError` after
    ``timeout_s`` (every rank is then killed)."""
    check_transport(backend, device, mesh.size)
    if resolve_device(device).type == "cuda":
        from ..kernels import KERNELS, build

        build.build_all(src for _, _, src in KERNELS)  # once, not once per rank
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as workdir:
        # Through a file, not the spawn pipe: a start blocks while a child
        # has not read its pickled arguments, so large ones would start the
        # ranks one after another.
        torch.save((fn, _pack(tuple(args))), os.path.join(workdir, "job.pt"))
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(mesh, backend, device, workdir, timeout_s, threads),
            nprocs=mesh.size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{mesh.size} ranks of {getattr(fn, '__name__', fn)} "
                                       f"still running after {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                        p.join(10)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(mesh.size)]


def summed_launches(records: Sequence[dict]) -> Dict[str, int]:
    """Kernel launches added up over the ranks' records."""
    total: Dict[str, int] = collections.Counter()
    for rec in records:
        total.update(rec["launches"])
    return dict(total)


def rank_rows(n_rows: int, comm: Comm, axes) -> slice:
    """This rank's contiguous share of ``n_rows`` split over ``axes``."""
    n, i = comm.axis_size(axes), comm.axis_index(axes)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over {n} ranks")
    per = n_rows // n
    return slice(i * per, (i + 1) * per)


def local_rows(batch: Dict[str, Any], comm: Comm, axes) -> Dict[str, torch.Tensor]:
    """This rank's rows (dim 0 split over ``axes``) of a global batch of
    arrays or tensors, as tensors on the rank's device."""
    out = {}
    for k, v in batch.items():
        rows = rank_rows(len(v), comm, axes)
        out[k] = torch.as_tensor(v[rows], device=comm.device)
    return out
