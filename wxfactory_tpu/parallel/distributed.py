"""Multi-controller (multi-host) execution support.

The reference scales out with one MPI process per cubed-sphere tile
(process_topology.py:50-267 there) and gates every host-side effect on
rank 0 (wx_mpi.py:16-165: SingleProcess/Conditional/do_once). The
JAX equivalent is multi-controller JAX: every host runs the same
program, ``jax.distributed.initialize()`` stitches the per-host device sets
into one global platform, the (panel, y, x) mesh simply spans all hosts'
devices (GSPMD/shard_map collectives ride the links within a host and
the network across hosts), and rank-0 side effects become ``jax.process_index() == 0``
guards. Nothing about the cube topology or the solver stack changes —
the same jitted programs run on 1 process or N.

IO under multi-controller needs two primitives this module provides:

* :func:`gather_global` — fetch a (possibly cross-process sharded) global
  array as host numpy on every process; the analogue of the reference's
  ``gather_cube`` to rank 0 (process_topology.py:444), done with an
  all-gather over DCN. Right for small/medium states (checkpoints,
  NetCDF output).
* :func:`save_state_distributed` / :func:`load_state_distributed` —
  checkpoint/restart that works when the global array spans hosts: small
  states gather and write the reference's single-file on-disk format
  (output/state.py); large states write one ``.npy`` per addressable shard
  plus a JSON manifest, and restart reassembles from the manifest at ANY
  process count (the analogue of the reference's restart-at-different-PE-
  count capability, tests/unit/restart test_multisize there).
"""

import json
import os
from typing import Optional, Tuple

import numpy as np

import jax

_SMALL_STATE_BYTES = 1 << 28  # 256 MB: gather-and-single-file below this


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> Tuple[int, int]:
    """Initialize multi-controller JAX. No-op for single-process runs
    (num_processes absent or 1). Returns (process_index, process_count)."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    return jax.process_index(), jax.process_count()


def is_primary() -> bool:
    """True on the process that owns host-side effects (rank-0 analogue,
    reference wx_mpi.py:16)."""
    return jax.process_index() == 0


def primary_print(*args, **kwargs) -> None:
    if is_primary():
        print(*args, **kwargs)


def gather_global(arr) -> np.ndarray:
    """Global host-numpy view of ``arr`` on EVERY process.

    Fully-addressable arrays (single process, or replicated) convert
    directly; cross-process sharded arrays all-gather their shards over DCN
    (jax.experimental.multihost_utils.process_allgather)."""
    if not isinstance(arr, jax.Array):
        return np.asarray(arr)
    if arr.is_fully_addressable:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


# ----------------------------------------------------------------------
# Checkpoint / restart across hosts
# ----------------------------------------------------------------------

def save_state_distributed(
    arr, config, path: str, panel_major: bool = True, small_bytes: int = _SMALL_STATE_BYTES
) -> None:
    """Checkpoint a (possibly cross-process sharded) global array.

    Small states (< 256 MB): gather everywhere, primary writes the
    reference-format single file (output/state.py). Large states: every
    process writes one ``<path>.shard<k>.npy`` per addressable shard it
    owns, and the primary writes ``<path>`` as a JSON manifest carrying the
    global shape/dtype, the shard index map and the config text."""
    from ..output.state import save_state

    nbytes = int(np.prod(arr.shape)) * arr.dtype.itemsize
    if not isinstance(arr, jax.Array) or arr.is_fully_addressable or nbytes < small_bytes:
        state = gather_global(arr)
        if is_primary():
            save_state(state, config, path, panel_major=panel_major)
        _barrier()
        return

    shards = []
    for shard in arr.addressable_shards:
        if shard.replica_id != 0:
            continue  # one writer per distinct shard
        idx = _index_to_json(shard.index, arr.shape)
        fname = f"{path}.shard{jax.process_index()}_{shard.device.id}.npy"
        np.save(fname, np.asarray(shard.data))
        shards.append({"file": os.path.basename(fname), "index": idx})

    manifests = _allgather_py(shards)
    if is_primary():
        manifest = {
            "format": "wxfactory_tpu-sharded-state",
            "version": "1.0",
            "global_shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "panel_major_file": False,  # shards are stored in memory layout
            "shards": [s for group in manifests for s in group],
            "config": getattr(config, "raw_text", ""),
        }
        with open(path, "w") as fh:
            json.dump(manifest, fh)
    _barrier()


def load_state_distributed(path: str, panel_major: bool = True):
    """Load a checkpoint written by :func:`save_state_distributed` (either
    form) as a GLOBAL numpy array on every process; returns
    (state, config_text_or_None). Works at any process count — every
    process reads the manifest + all shards (restart is PE-count
    independent, like the reference's distribute_cube path)."""
    with open(path, "rb") as fh:
        head = fh.read(32)
    if head.startswith(b"{"):
        with open(path) as fh:
            manifest = json.load(fh)
        out = np.empty(manifest["global_shape"], dtype=np.dtype(manifest["dtype"]))
        d = os.path.dirname(path)
        for s in manifest["shards"]:
            idx = _index_from_json(s["index"])
            out[idx] = np.load(os.path.join(d, s["file"]))
        return out, manifest.get("config") or None

    from ..output.state import load_state

    state, config, _version = load_state(path, panel_major=panel_major, parse_config=False)
    return state, config


def _index_to_json(index, shape):
    out = []
    for sl, n in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = n if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def _index_from_json(idx):
    return tuple(slice(a, b) for a, b in idx)


def _allgather_py(obj):
    """All-gather a small picklable object across processes (manifest
    assembly). Single-process: [obj]."""
    if jax.process_count() == 1:
        return [obj]
    from jax.experimental import multihost_utils

    # Encode as bytes -> fixed-size padded uint8 array all-gather.
    import pickle

    payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
    n = np.zeros((1,), np.int64)
    n[0] = payload.size
    sizes = multihost_utils.process_allgather(n)  # (nproc, 1)
    cap = int(sizes.max())
    buf = np.zeros((cap,), np.uint8)
    buf[: payload.size] = payload
    data = multihost_utils.process_allgather(buf)  # (nproc, cap)
    return [pickle.loads(bytes(data[i, : int(sizes[i, 0])])) for i in range(data.shape[0])]


def _barrier() -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("wxfactory_tpu_state_io")
