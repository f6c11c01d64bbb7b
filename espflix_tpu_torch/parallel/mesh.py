"""Device mesh and sharding for the decoders: the port of
espflix_tpu.parallel.mesh.

The JAX mesh is single-controller: one process and one Fleet hold every
lane's session, and shard_map runs the decode per shard.  The port keeps
that shape in one process:

  * a ``Mesh`` is an array of torch devices with axis names and a
    ``shape`` dict (``mesh.shape["streams"]``).  A device may repeat:
    ``[torch.device("cpu")] * 8`` is the tests' counterpart of the JAX
    tests' 8 virtual CPU devices, ``[cuda:0] * 4`` a 4-shard mesh on one
    card;
  * a sharded value is a ``Sharded`` list of its per-shard tensors, one
    per mesh position in the row-major order of the device array, each
    on its position's device; ``shard`` / ``unshard`` cut and join them
    by a spec that names the mesh axis of each leading tensor axis, as
    a PartitionSpec does.  Lane groups are contiguous;
  * the collectives are explicit copies: the 'space' all-gather is a
    torch.cat of .to(device) copies, the tap psum of the sharded chain
    (runtime/chain.py) a sum of the masked per-shard taps on the first
    device, ``gather_metrics`` the errored-lane sum and the max of
    iters.

Each decoder issues every shard's work before anything waits for a
card, so shards on distinct cards overlap.  The decoders run the port's
kernels on CUDA devices and their plain forms on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from espflix_tpu_torch.models import mpeg1 as M
from espflix_tpu_torch.ops import vlc_scan as VS

LANES = ("streams",)
AXIS1 = (None, "streams")


class Mesh:
    """Devices in an array of named axes."""

    def __init__(self, devices, axis_names):
        devs = np.empty(len(devices), object)
        devs[:] = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.devices = devs
        self.shape = {}

    def reshape(self, *dims) -> "Mesh":
        assert len(dims) == len(self.axis_names)
        self.devices = self.devices.reshape(dims)
        self.shape = dict(zip(self.axis_names, dims))
        return self

    @property
    def size(self) -> int:
        return self.devices.size

    def device_list(self) -> list:
        """Devices in mesh-position order (the order of a Sharded)."""
        return list(self.devices.flat)

    @property
    def first(self) -> torch.device:
        return self.devices.flat[0]


class Sharded(list):
    """A sharded value: its per-shard tensors in mesh-position order."""


def _all_devices(devices):
    if devices is not None:
        return list(devices)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass devices= (e.g. "
                           "[torch.device('cpu')] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_streams_axis: int | None = None, devices=None) -> Mesh:
    """1-D 'streams' mesh over the first n_streams_axis devices (every
    CUDA device by default)."""
    devices = _all_devices(devices)
    n = n_streams_axis or len(devices)
    return Mesh(devices[:n], ("streams",)).reshape(n)


def make_space_mesh(streams: int, space: int, devices=None) -> Mesh:
    """2-D mesh (streams, space): lanes shard over 'streams', MB rows of
    each frame over 'space'."""
    devices = _all_devices(devices)
    assert streams * space <= len(devices)
    return Mesh(devices[:streams * space],
                ("streams", "space")).reshape(streams, space)


def _tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not a.flags.writeable:       # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a)


def shard(mesh: Mesh, x, spec) -> Sharded:
    """Cut tensor (or numpy array) x for the mesh: tensor axis d splits
    into equal contiguous parts over mesh axis spec[d] (None or past the
    spec: whole); each part is copied to its position's device."""
    t = _tensor(x)
    parts = Sharded()
    for pos in np.ndindex(mesh.devices.shape):
        sl = [slice(None)] * t.dim()
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            k = mesh.axis_names.index(ax)
            n = mesh.devices.shape[k]
            assert t.shape[d] % n == 0, (t.shape, spec, mesh.shape)
            size = t.shape[d] // n
            sl[d] = slice(pos[k] * size, (pos[k] + 1) * size)
        parts.append(t[tuple(sl)].to(mesh.devices[pos], copy=True)
                     .contiguous())
    return parts


def unshard(mesh: Mesh, parts, spec, device=None) -> torch.Tensor:
    """Join a Sharded back into one tensor on `device` (the mesh's first
    device by default); positions that replicate a part give its first
    copy."""
    device = mesh.first if device is None else torch.device(device)
    if not isinstance(parts, Sharded):
        return parts.to(device)
    grid = np.empty(mesh.devices.shape, object)
    for i, p in enumerate(parts):
        grid.flat[i] = p
    dims = []                      # tensor axis of each mesh axis kept
    for k, ax in enumerate(mesh.axis_names):
        if ax in spec:
            dims.append(list(spec).index(ax))
        else:
            grid = np.take(grid, [0], axis=k)
            dims.append(None)
    grid = grid.reshape([s for s, d in zip(grid.shape, dims)
                         if d is not None] or [1])
    dims = [d for d in dims if d is not None]

    def join(g, level):
        if level == len(dims):
            return (g.item() if isinstance(g, np.ndarray) else g).to(device)
        return torch.cat([join(g[i], level + 1) for i in range(g.shape[0])],
                         dim=dims[level])
    return join(grid, 0)


def tree_map(fn, tree):
    """fn over the leaves of nested dicts / tuples / lists; a Sharded is
    a leaf."""
    if isinstance(tree, Sharded):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_sharded(mesh: Mesh, x, spec):
    return x if isinstance(x, Sharded) else shard(mesh, x, spec)


def shard_lane_tree(mesh: Mesh, tree):
    """Every leaf cut along axis 0 (the lane axis) over 'streams'; leaves
    already Sharded stay as they are."""
    return tree_map(lambda x: _as_sharded(mesh, x, LANES), tree)


def shard_axis1_tree(mesh: Mesh, tree):
    """[K, lanes-or-rows, ...] leaves cut along axis 1 over 'streams'."""
    return tree_map(lambda x: _as_sharded(mesh, x, AXIS1), tree)


def unshard_tree(mesh: Mesh, tree, spec=LANES, device=None):
    """unshard over the Sharded leaves of a tree."""
    return tree_map(lambda x: unshard(mesh, x, spec, device)
                    if isinstance(x, Sharded) else x, tree)


def local(tree, i: int):
    """Shard i of every Sharded leaf."""
    return tree_map(lambda x: x[i] if isinstance(x, Sharded) else x, tree)


def stack_shards(outs: list):
    """Per-shard output trees -> one tree of Sharded leaves."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: stack_shards([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_shards([o[j] for o in outs])
                           for j in range(len(first)))
    return Sharded(outs)


_TABLES: dict = {}


def decode_tables(device) -> dict:
    """models/mpeg1.decode_tables, one per device."""
    device = torch.device(device)
    if device not in _TABLES:
        _TABLES[device] = M.decode_tables(device)
    return _TABLES[device]


def _streams_only(mesh: Mesh):
    if mesh.axis_names != ("streams",):
        raise ValueError(f"a 'streams' mesh is needed, got {mesh.shape}")


def make_sharded_decoder(mesh: Mesh, *, mb_width: int, mb_height: int,
                         max_steps: int):
    """The device parser per shard (mesh.py:47-81): decode(words,
    slice_starts, slice_rows, n_slices, pic_type, full_pel, r_size,
    intra_q, non_intra_q, active, frames) -> (frames, presented, info),
    every input and output lane-major and sharded over 'streams' (a
    tensor or numpy input is sharded on entry).  Each shard runs
    models/mpeg1.decode_picture_impl (K1S, K2F, K3F) on its lanes."""
    _streams_only(mesh)

    def decode(*args):
        *lane_args, frames = args
        lane_args = [_as_sharded(mesh, a, LANES) for a in lane_args]
        frames = shard_lane_tree(mesh, frames)
        outs = []
        for i, dev in enumerate(mesh.device_list()):
            outs.append(M.decode_picture_impl(
                *[a[i] for a in lane_args], local(frames, i),
                mb_width=mb_width, mb_height=mb_height, max_steps=max_steps,
                tables=decode_tables(dev)))
        return stack_shards(outs)
    return decode


def make_sharded_pallas_decoder(mesh: Mesh, *, mb_width: int,
                                mb_height: int, long_rows: int,
                                steps_long: int = 1024,
                                steps_short: int = 384,
                                chunk: int = 128):
    """The slice-scan parser per shard (mesh.py:84-142): decode(words,
    start_bits, rows, alive, pic_type, full_pel, r_size, lane_of_row,
    perm, intra_q, non_intra_q, active, frames) -> (frames, presented,
    info), with rows from scan_dense.pack_slice_rows_sharded (each
    shard's rows self-contained) and every input sharded over
    'streams'.  Each shard runs the two-bucket dense scan (K1), K2, the
    predict-only K3P (rule A) and the compose in torch ops
    (models/mpeg1.dense_compose_unfused), as the JAX decoder runs
    dense_compose with use_pallas_mocomp.  long_rows and the budgets
    are per shard."""
    _streams_only(mesh)

    def decode(*args):
        *row_args, frames = args
        row_args = [_as_sharded(mesh, a, LANES) for a in row_args]
        frames = shard_lane_tree(mesh, frames)
        outs = []
        for i, dev in enumerate(mesh.device_list()):
            (words, start_bits, rows, alive, pic_type, full_pel, r_size,
             lane_of_row, perm, intra_q, non_intra_q, active) = \
                [a[i] for a in row_args]
            tables = decode_tables(dev)
            n_loc = active.shape[0]
            coeffs_T, recs, nfinal, err, iters = VS.run_scan_bucketed_dense(
                words, start_bits, rows, alive, pic_type, full_pel, r_size,
                lane_of_row, perm, mb_width=mb_width, mb_height=mb_height,
                n_lanes=n_loc, long_rows=long_rows, steps_long=steps_long,
                steps_short=steps_short, chunk=min(chunk, steps_short),
                lut=tables["lut"], zigzag=tables["zigzag"])
            fr, pres = M.dense_compose_unfused(
                coeffs_T, recs, nfinal, intra_q, non_intra_q, active,
                local(frames, i), mb_width=mb_width, mb_height=mb_height,
                transposed=True, scale_dct=tables["scale_dct"])
            outs.append((fr, pres, dict(error=err, ok=active & ~err,
                                        iters=iters.expand(n_loc))))
        return stack_shards(outs)
    return decode


def gather_metrics(mesh: Mesh, error, iters):
    """Cross-shard metric reduction: (total errored lanes, max scan
    iterations) as 0-d tensors on the mesh's first device."""
    dev = mesh.first
    error = error if isinstance(error, Sharded) else [error]
    iters = iters if isinstance(iters, Sharded) else [iters]
    errs = sum(e.to(dev).sum() for e in error)
    return errs, torch.stack([i.to(dev).max() for i in iters]).max()


# ---------------------------------------------------------------------------
# the 'space' axis: MB-row sharding of the dense phase
# ---------------------------------------------------------------------------

SPACE2 = ("streams", "space")
FRAME_PLANES = ("streams", None, "space", None)
PRESENTED = ("streams", "space", None)


def frames_specs():
    """The 'space' split's frame specs: planes cut over streams and
    rows, parity over streams."""
    return dict(y=FRAME_PLANES, u=FRAME_PLANES, v=FRAME_PLANES,
                parity=LANES)


def make_space_sharded_dense(mesh: Mesh, *, mb_width: int, mb_height: int):
    """The lane-minor dense phase sharded over lanes ('streams') and MB
    rows ('space') (mesh.py:170-246): dense(coeffs3, recs3, nfinal3,
    intra_q, non_intra_q, active, frames) -> (frames, presented).

    coeffs3 int16[N, mbh, mbw*384], recs3 int32[N, mbh, mbw], nfinal3
    int32[N, mbh, mbw*6] cut over (streams, space); intra_q /
    non_intra_q / active over streams; frames y/u/v [N, 2, H, W] over
    (streams, rows) and parity over streams (frames_specs()).  Tensors
    are sharded on entry.  Each (streams, space) shard gathers the full
    reference planes from the shards of its row (the all-gather along
    'space', the one collective on the data path), then runs K2F, K3P
    with rule B over its band and the compose (models/mpeg1.
    dense_compose_unfused with ref_planes).  presented y/u/v come cut
    over (streams, rows)."""
    n_sp = mesh.shape["space"]
    assert mb_height % n_sp == 0, \
        f"mb_height {mb_height} not divisible by space={n_sp}"
    mbh_loc = mb_height // n_sp
    mb_loc = mbh_loc * mb_width
    fspec = frames_specs()

    def dense(coeffs3, recs3, nfinal3, intra_q, non_intra_q, active,
              frames):
        c3, r3, n3 = (_as_sharded(mesh, a, SPACE2)
                      for a in (coeffs3, recs3, nfinal3))
        iq, nq, act = (_as_sharded(mesh, a, LANES)
                       for a in (intra_q, non_intra_q, active))
        frames = {k: _as_sharded(mesh, v, fspec[k])
                  for k, v in frames.items()}
        devs = mesh.device_list()
        # every shard's reference band first, then the gathered planes
        refs = []
        for i in range(len(devs)):
            fr = local(frames, i)
            lanes = torch.arange(fr["parity"].shape[0],
                                 device=fr["parity"].device)
            ref_slot = 1 - fr["parity"].long()
            refs.append([fr[k][lanes, ref_slot] for k in "yuv"])
        outs = []
        for i, dev in enumerate(devs):
            s, j = divmod(i, n_sp)
            full = [torch.cat([refs[s * n_sp + jj][p].to(dev)
                               for jj in range(n_sp)], dim=1)
                    for p in range(3)]
            N = r3[i].shape[0]
            outs.append(M.dense_compose_unfused(
                c3[i].reshape(N, mb_loc * 384), r3[i].reshape(N, mb_loc),
                n3[i].reshape(N, mb_loc * 6), iq[i], nq[i], act[i],
                local(frames, i), mb_width=mb_width, mb_height=mbh_loc,
                transposed=False, ref_planes=full, row0_mb=j * mbh_loc,
                scale_dct=decode_tables(dev)["scale_dct"]))
        return stack_shards(outs)
    return dense
