"""Rank processes of the port's distributed parity tests.

tests/test_torch_parallel.py and tests/test_torch_sharded_map.py run the
port's ``parallel`` package at 2 ranks on the CPU: ``start`` writes the
inputs (numpy arrays) to a pickle and launches one
``python tests/_torch_parallel_worker.py <job> <inputs> <output>`` process
per rank, with torch's env vars (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``) so that ``multihost.initialize(backend="gloo")``
forms the group; ``Ranks.results`` waits for them and returns each rank's
result dict. The ranks import the port only, never JAX.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Ranks:
    """A job running at `world` gloo ranks, one process each."""

    def __init__(self, job: str, inputs: dict, tmpdir: str, world: int = 2):
        self.paths = [os.path.join(tmpdir, f"{job}_rank{r}.pkl") for r in range(world)]
        inp = os.path.join(tmpdir, f"{job}_inputs.pkl")
        with open(inp, "wb") as fh:
            pickle.dump(inputs, fh)
        port = str(_free_port())
        self.procs = []
        for r in range(world):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       WORLD_SIZE=str(world), RANK=str(r),
                       PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, inp, self.paths[r]],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True))

    def results(self, timeout: float = 240.0) -> list[dict]:
        """Each rank's result dict, in rank order; raises if a rank failed."""
        errs = []
        for p in self.procs:
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                raise
            errs.append(err)
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} failed (rc {p.returncode}):\n{errs[r][-4000:]}")
        out = []
        for path in self.paths:
            with open(path, "rb") as fh:
                out.append(pickle.load(fh))
        return out


def _np(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple):
        return type(x)(*[_np(v) for v in x]) if hasattr(x, "_fields") else tuple(map(_np, x))
    return x


def _state(arrays):
    import torch

    from sfm_mvs_tpu_torch.models.map_store import MapState

    return MapState(*[torch.as_tensor(a) for a in arrays])


def _raises(fn) -> str:
    """The AssertionError message fn raises ('' when it raises none)."""
    try:
        fn()
    except AssertionError as e:
        return str(e)
    return ""


def job_parallel(mesh, inp) -> dict:
    import torch

    from sfm_mvs_tpu_torch.models import ba, mvs
    from sfm_mvs_tpu_torch.ops.sift import Features
    from sfm_mvs_tpu_torch.parallel import consistency, distributed_ba, frontend, multihost
    from sfm_mvs_tpu_torch.utils.config import FrontendConfig

    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend}
    st = _state(inp["ba_state"])
    s, stats = distributed_ba.bundle_adjust_map_sharded(st, mesh, max_iterations=8, cg_iters=15)
    out["map_ba"] = (_np(s.poses), _np(s.points), [float(v) for v in stats])
    out["map_fingerprint"] = consistency.state_fingerprint(s)
    w, wstats = distributed_ba.bundle_adjust_window_sharded(
        st, mesh, window_cams=4, window_points=512, max_iterations=6, cg_iters=12, freeze_cams=1)
    out["window_ba"] = (_np(w.poses), _np(w.points), [float(v) for v in wstats])
    prob, _ = distributed_ba.run_ba_sharded(ba.problem_from_map(st), mesh, max_iterations=4,
                                            cg_iters=10)
    out["replicated"] = _raises(lambda: consistency.check_ba_replication(
        prob.cam_params, prob.points, mesh))
    out["cam_params"] = _np(prob.cam_params)
    out["diverged"] = _raises(lambda: consistency.assert_replicated(
        torch.full((4,), float(mesh.rank)), mesh, "x"))
    out["checksums"] = consistency.device_checksums(torch.arange(64.0), mesh)

    cfg = FrontendConfig(**inp["frontend_cfg"])
    feats = frontend.detect_batch_sharded(torch.as_tensor(inp["frames"]), cfg, mesh)
    out["detect"] = _np(feats)
    f = Features(*[torch.as_tensor(a) for a in inp["feats"]])
    m = frontend.match_pairs_sharded(f, torch.as_tensor(inp["pair0"]),
                                     torch.as_tensor(inp["pair1"]), mesh, cfg)
    out["match"] = _np(m)

    pts, cols = mvs.densify_map(list(inp["mvs_frames"]), _state(inp["mvs_state"]),
                                num_depths=48, stride=4, mesh=mesh)
    out["mvs"] = (pts, cols)

    out["slices"] = []
    for per in (1, 2):
        sm = multihost.slice_mesh(per)
        out["slices"].append((sm.hosts, sm.ranks_per_host, sm.ici.size, sm.ici.rank,
                              sm.dcn.size, sm.dcn.rank))
    return out


def job_sharded_map(mesh, inp) -> dict:
    import torch

    from sfm_mvs_tpu_torch.parallel import mesh as meshlib, sharded_map

    T = torch.as_tensor
    blk = meshlib.shard_map_state(_state(inp["state"]), mesh)
    X, ok = sharded_map.lookup_points_sharded(blk.points, blk.point_valid, T(inp["tids"]), mesh)
    pts = meshlib.shard_batch(T(inp["points"]), mesh)
    valid = meshlib.shard_batch(T(inp["valid"]), mesh)
    d2, z = sharded_map.nearest_projected_sharded(pts, valid, T(inp["pose"]), T(inp["K"]),
                                                  T(inp["uv_q"]), mesh)
    return {"rank": mesh.rank, "block": _np(blk), "lookup": (_np(X), _np(ok)),
            "nearest": (_np(d2), _np(z))}


def main() -> int:
    job, inp_path, out_path = sys.argv[1:4]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import sfm_mvs_tpu_torch  # noqa: F401  (full-fp32 matmul flags)
    from sfm_mvs_tpu_torch.parallel import mesh, multihost

    if not multihost.initialize(backend="gloo"):
        raise RuntimeError("multihost.initialize found no process group in the env vars")
    with open(inp_path, "rb") as fh:
        inputs = pickle.load(fh)
    res = {"parallel": job_parallel, "sharded_map": job_sharded_map}[job](mesh.make_mesh(), inputs)
    res["jax_loaded"] = "jax" in sys.modules
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
