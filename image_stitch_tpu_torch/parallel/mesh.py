"""Multi-device band programs over a mesh of torch devices.

The counterpart of ``image_stitch_tpu/parallel/mesh.py``. One process drives
every device of the mesh, as JAX's single controller does: no
``torch.distributed``, no NCCL. A mesh is a (band, x) array of
``torch.device``; a device may repeat, and then its shards are *virtual*:
on a card each shard gets a CUDA stream of its own, on the CPU the shards
run one after another. ``make_mesh(n, device="cpu")`` makes up to
``CPU_SHARDS`` virtual shards of the CPU, the JAX test suite's count of host
devices.

Every sharded program splits the band's rows, whatever the factoring:
``row_slabs`` gives each device of ``mesh.flat()`` a run of consecutive
rows, so that a band composited on the shards is filtered or encoded there
without moving. The JAX package shards columns over 'x' too; on the card a
column split of the PNG filter would add each row's five candidate sums
across devices before the argmin, where a row split needs one halo row per
slab and no exchange. The bytes are the same for any split, which is what
the JAX package's tests assert for every factoring. ``mesh.shape`` keeps the
(band, x) factoring because callers read it.

Each shard's work runs inside ``mesh.shard(i)``: on a card, its stream first
waits for the device's current stream and the current stream waits for it
at the end, so that work queued outside the shards is ordered as if it ran
on one stream, and the shards of one program overlap each other.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import numpy as np
import torch

from ..errors import StitchError
from ..ops.resolve import resolve_device
from ..ops.staging import upload

# Virtual shards a CPU mesh may have: the JAX test suite's forced host
# device count (tests/conftest.py), so that both packages refuse the same
# meshes.
CPU_SHARDS = 8


class Mesh:
    """A (band, x) array of torch devices, band-major; a device may repeat.

    ``devices`` is the numpy object array, ``axis_names`` its axes,
    ``shape`` maps each axis to its size (as JAX's ``mesh.shape``), ``size``
    counts the shards and ``flat()`` lists their devices in shard order."""

    def __init__(self, devices, axis_names: Sequence[str] = ("band", "x")):
        arr = np.asarray(devices, dtype=object)
        given = [torch.device(d) for d in arr.reshape(-1)]
        if not given:
            raise StitchError("a mesh needs at least one device")
        if arr.ndim != len(axis_names):
            raise StitchError(f"mesh devices of shape {arr.shape} for axes {tuple(axis_names)}")
        kinds = {d.type for d in given}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise StitchError(f"a mesh's devices must all be cuda or all cpu, got {sorted(kinds)}")
        # A card given with its index is kept unchecked, so that a mesh may
        # describe cards that a later call refuses on a machine without them
        # (an entry point then names the mesh's device kind); "cuda" is the
        # current card.
        flat = [d if d.index is not None else resolve_device(d) for d in given]
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = tuple(axis_names)
        self._flat = flat
        self._streams: dict[int, torch.cuda.Stream] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return len(self._flat)

    @property
    def device_type(self) -> str:
        return self._flat[0].type

    def flat(self) -> list[torch.device]:
        return list(self._flat)

    def distinct(self) -> list[torch.device]:
        """The mesh's devices, each once, in shard order."""
        return list(dict.fromkeys(self._flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self._flat]})"

    @contextlib.contextmanager
    def shard(self, i: int) -> Iterator[torch.device]:
        """Run the body as shard ``i``: on a card, on the shard's device and
        its own stream, forked from the device's current stream and joined
        back into it. Yields the shard's device."""
        dev = self._flat[i]
        if dev.type != "cuda":
            yield dev
            return
        stream = self._streams.get(i)
        if stream is None:
            stream = self._streams[i] = torch.cuda.Stream(device=dev)
        with torch.cuda.device(dev):
            current = torch.cuda.current_stream(dev)
            stream.wait_stream(current)
            try:
                with torch.cuda.stream(stream):
                    yield dev
            finally:
                current.wait_stream(stream)


def make_mesh(n_devices: int | None = None, axes: tuple[str, ...] = ("band", "x"),
              device="cuda") -> Mesh:
    """A mesh over the first ``n_devices`` cards (all of them by default),
    or over ``n_devices`` virtual shards of the CPU (``CPU_SHARDS`` at
    most). With 2 axes the devices are factored as near-square as possible,
    band-major; with 1 axis all go to it."""
    kind = torch.device(device).type
    if kind == "cuda":
        available = torch.cuda.device_count() if torch.cuda.is_available() else 0
        source = "torch.cuda.device_count()"
    elif kind == "cpu":
        available = CPU_SHARDS
        source = "virtual CPU shards, CPU_SHARDS"
    else:
        raise StitchError(f"Unsupported mesh device: {device}")
    n = n_devices or available
    if not 1 <= n <= available:
        raise StitchError(
            f"mesh requests {n} devices but only {available} are available ({source})"
        )
    devices = ([torch.device("cuda", i) for i in range(n)] if kind == "cuda"
               else [torch.device("cpu")] * n)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    if len(axes) == 1:
        return Mesh(arr, axes)
    # Factor n into (band, x) as near-square as possible.
    b = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            b = cand
            break
    return Mesh(arr.reshape(b, n // b), axes)


def row_slabs(h: int, n_shards: int, align: int = 1) -> list[tuple[int, int]]:
    """Rows [r0, r1) of an ``h``-row band for each of ``n_shards`` shards:
    consecutive runs of whole ``align``-row units, as even as the units
    allow, the first shards taking one more; a last unit cut short by the
    band's end goes to the shard that holds it, and trailing shards may get
    no rows."""
    units = -(-h // align)
    base, extra = divmod(units, n_shards)
    out, u = [], 0
    for i in range(n_shards):
        k = base + (i < extra)
        out.append((min(h, u * align), min(h, (u + k) * align)))
        u += k
    return out


class ShardedBand:
    """An (h, W, C) band whose rows lie in slabs on a mesh's devices: what
    the compositor hands to the encoders under a mesh. ``slabs`` holds
    (first row, tensor) in row order, back to back."""

    def __init__(self, slabs: Sequence[tuple[int, torch.Tensor]]):
        self.slabs = list(slabs)
        first = self.slabs[0][1]
        self.shape = (sum(t.shape[0] for _, t in self.slabs), *first.shape[1:])
        self.dtype = first.dtype
        self.ndim = first.ndim

    def rows(self, r0: int, r1: int, device: torch.device) -> torch.Tensor:
        """Rows [r0, r1) on ``device``: a view where one slab there holds
        them all, else the pieces copied and joined."""
        pieces = [t[max(r0, s0) - s0 : min(r1, s0 + t.shape[0]) - s0]
                  for s0, t in self.slabs if s0 < r1 and s0 + t.shape[0] > r0]
        if len(pieces) == 1 and pieces[0].device == device:
            return pieces[0]
        return torch.cat([p.to(device) for p in pieces])

    def cpu(self) -> torch.Tensor:
        return torch.cat([t.cpu() for _, t in self.slabs])


def band_rows(band, r0: int, r1: int, device: torch.device) -> torch.Tensor:
    """Rows [r0, r1) of ``band`` on ``device``: a host array uploaded
    (``ops.staging.upload``), a tensor viewed where it lies or copied, a
    ``ShardedBand`` read from its slabs."""
    if isinstance(band, ShardedBand):
        return band.rows(r0, r1, device)
    if isinstance(band, torch.Tensor):
        part = band[r0:r1]
        return part if part.device == device else part.to(device, non_blocking=True)
    return upload(band[r0:r1], device)


# --------------------------------------------------------------------------- #
# Sharded fused grid steps
# --------------------------------------------------------------------------- #


def _grid_step(mesh: Mesh, png: bool, jpeg: bool):
    """The fused step's work over the mesh: the canvas rows split by
    ``row_slabs`` (whole 8-row strips where the JPEG half runs), each
    non-empty slab one ``kernels.grid_dual`` over its rows of the tile stack
    on its shard, which reads the row above the slab from the tiles (the
    halo costs no copy); a shard on another card first gets the tile rows
    its slab and its halo lie in. The results are gathered onto the mesh's
    first device in row order; the last raw row is the last slab's."""
    from ..ops.kernels import grid_dual

    first = mesh.flat()[0]

    def step(tiles: torch.Tensor, *args):
        th = tiles.shape[2]
        h = tiles.shape[0] * th
        prev = args[0] if png else None
        lq, cq = args[-2:] if jpeg else (None, None)
        outs = []
        for i, (r0, r1) in enumerate(row_slabs(h, mesh.size, 8 if jpeg else 1)):
            if r1 == r0:
                continue
            with mesh.shard(i) as dev:
                t0 = max(r0 - 1, 0) // th
                part = band_rows(tiles, t0, -(-r1 // th), dev)
                p = prev.to(dev, non_blocking=True) if png and r0 == 0 else None
                qs = [q.to(dev, non_blocking=True) for q in (lq, cq)] if jpeg else [None, None]
                outs.append(grid_dual(part, p, *qs, r0 - t0 * th, r1 - t0 * th, png, jpeg))
        return tuple(outs[-1][k].to(first) if png and k == 2
                     else torch.cat([o[k].to(first) for o in outs])
                     for k in range(len(outs[0])))

    return step


def shard_grid_png_step(mesh: Mesh):
    """``fused_grid_png_step`` over the mesh: (tiles, prev_row) ->
    (filter types (H,) int32, filtered (H, W*4) uint8, last raw row), on
    the mesh's first device."""
    return _grid_step(mesh, png=True, jpeg=False)


def shard_grid_jpeg_step(mesh: Mesh):
    """``fused_grid_jpeg_step`` over the mesh: (tiles, luma_q, chroma_q) ->
    (y, cb, cr) quantized blocks, strip-major, on the mesh's first device."""
    return _grid_step(mesh, png=False, jpeg=True)


def shard_grid_dual_step(mesh: Mesh):
    """The full forward step (PNG and JPEG encoders off one canvas) over
    the mesh: ``fused_grid_dual_step``'s arguments and results."""
    return _grid_step(mesh, png=True, jpeg=True)


def run_multichip_demo(n_devices: int, gy: int = 2, gx: int = 8, th: int = 16, tw: int = 16,
                       device="cuda"):
    """Run the sharded dual step once on tiny shapes over an ``n_devices``
    mesh. The demo tile grid is scaled up so that both mesh axes divide it,
    whatever (band, x) factoring ``make_mesh`` picks, as the JAX package's
    demo does, so both draw the same tiles."""
    from ..codecs.jpeg.tables import quality_scaled_tables

    mesh = make_mesh(n_devices, device=device)
    band_n, x_n = mesh.shape["band"], mesh.shape["x"]
    gy = -(-gy // band_n) * band_n  # round up to a band-axis multiple
    gx = -(-gx // x_n) * x_n  # round up to an x-axis multiple
    first = mesh.flat()[0]
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(
        rng.integers(0, 256, size=(gy, gx, th, tw, 4), dtype=np.uint8)).to(first)
    prev = torch.zeros(gx * tw * 4, dtype=torch.uint8, device=first)
    lq, cq = (torch.from_numpy(q).to(first) for q in quality_scaled_tables(85))
    out = shard_grid_dual_step(mesh)(tiles, prev, lq, cq)
    if first.type == "cuda":
        torch.cuda.synchronize(first)
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the sharded dual step, then whole runs over an ``n_devices`` mesh,
    each byte-identical to the host tier (``backend="numpy"``): a 2 x 2 grid
    to PNG and to JPEG with restart rows 1, and the flagship's shape scaled
    down, a 16-column grid streamed to JPEG with restart groups. Raises
    ``RuntimeError`` on a difference."""
    from .. import concat_streaming, concat_to_buffer
    from ..codecs.png.batch import compress_image_data
    from ..codecs.png.writer import build_png
    from ..types import PngHeader

    run_multichip_demo(n_devices, gy=2, gx=max(8, n_devices), th=16, tw=16, device=device)

    rng = np.random.default_rng(0)

    def tile_png(arr: np.ndarray) -> bytes:
        h, w = arr.shape[:2]
        header = PngHeader(width=w, height=h, bit_depth=8, color_type=6)
        return build_png(header, compress_image_data(arr.reshape(h, -1), header))

    tiles = [tile_png(rng.integers(0, 256, (40, 48, 4), dtype=np.uint8)) for _ in range(4)]
    for opts in ({"outputFormat": "png"},
                 {"outputFormat": "jpeg", "jpeg_restart_interval_rows": 1}):
        common = {"inputs": tiles, "layout": {"columns": 2}, "bandHeight": 16}
        sharded = concat_to_buffer({**common, **opts, "mesh": n_devices}, device=device)
        host = concat_to_buffer({**common, **opts, "backend": "numpy"}, device=device)
        if sharded != host:
            raise RuntimeError(f"sharded != host bytes for {opts}")

    ns_tiles = [tile_png(rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)) for _ in range(4)]
    ns_common = {
        "inputs": [ns_tiles[i % 4] for i in range(16 * 16)], "layout": {"columns": 16},
        "outputFormat": "jpeg", "jpegQuality": 85,
        "jpeg_restart_interval_rows": 1, "bandHeight": 32,
    }
    ns_host = b"".join(concat_streaming({**ns_common, "backend": "numpy"}, device=device))
    ns_shard = b"".join(concat_streaming({**ns_common, "mesh": n_devices}, device=device))
    if ns_shard != ns_host:
        raise RuntimeError("northstar-shape sharded != host bytes")
    print(f"multichip dryrun ok: {n_devices}-device mesh, sharded == host bytes")
