"""Readings behind the auto bootstrap's guard (``IncrementalSfM._run_auto``).

    python3 scripts/bootstrap_guard_readings.py --seeds 1,2,3 --streams 30 [--witness]

On the benchmark's gustav57 scene (``portbench/configs/gustav57.json``;
texture from each seed, as the cell renders it), per seed: detection of
the 57 frames, the windowed view graph of the cell's first pass, then
``init_from_bootstrap`` on the pair the graph picks under `--streams`
generator streams. Each bootstrap prints one JSON line with its rotation
and translation-direction disagreement with the graph's own estimate of
the pair (what the guard compares) and with the rendered ground truth.

``--witness`` adds the sequential bootstrap on frames 0 and 1 of seed
5200000003, pass 5 of the benchmark's incremental driver (generator
``seed_int(seed, 2, 5)``), which builds a wrong two-view geometry, against
view graphs of frames 0-8 under several streams, with K as the
configuration gives it and at full precision. Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import pipeline
from portbench.harness import Context, load_json, seed_int
from portbench.run import HERE

WITNESS_SEED = 5200000003
WITNESS_PASS = 5


def gt_disagreement(Rt, a, b, pose1):
    """(rotation, direction) degrees of a two-view pose against the
    ground truth's relative pose of frames a and b."""
    Ra, ta = Rt[a][:, :3], Rt[a][:, 3]
    Rb, tb = Rt[b][:, :3], Rt[b][:, 3]
    R = Rb @ Ra.T
    t = tb - R @ ta
    p = pose1.double().cpu().numpy()
    c = np.clip((np.trace(p[:, :3] @ R.T) - 1) / 2, -1, 1)
    d = np.clip(p[:, 3] @ t / (np.linalg.norm(p[:, 3]) * np.linalg.norm(t)), -1, 1)
    return float(np.degrees(np.arccos(c))), float(np.degrees(np.arccos(d)))


def scene(config, seed, device):
    cell = {"name": "gustav57-viewgraph", "chips": 1}
    ctx = Context(cell=cell, config=config, traffic={}, seed=seed, seconds=0.0, trace=False,
                  device=device, t_start=time.perf_counter())
    sc = pipeline.render(ctx)
    host8 = pipeline.stage_u8(sc.images).cpu().numpy()
    return sc, [h.astype(np.float32) / np.float32(255.0) for h in host8]


def detect(images, cfg, device):
    from sfm_mvs_tpu_torch.ops import sift

    return [sift.detect_and_compute(torch.as_tensor(g, device=device), cfg.frontend)
            for g in images]


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", required=True)
    p.add_argument("--streams", type=int, default=30)
    p.add_argument("--witness", action="store_true")
    args = p.parse_args(argv)
    from sfm_mvs_tpu_torch.models import exhaustive, incremental
    from sfm_mvs_tpu_torch.ops import matching_cuda

    dev = torch.device("cuda", 0)
    matching_cuda.build()
    config = load_json(HERE / "configs" / "gustav57.json")
    cfg = pipeline.sfm_config(config)
    K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
    for seed in (int(s) for s in args.seeds.split(",")):
        sc, images = scene(config, seed, dev)
        feats = detect(images, cfg, dev)
        pass_seed = seed_int(seed, 2, 1)
        t = time.perf_counter()
        graph = exhaustive.build_view_graph(images, cfg, seed=pass_seed, feats=feats,
                                            window=cfg.view_graph_window)
        graph_s = time.perf_counter() - t
        a, b = exhaustive.best_bootstrap_pair(graph)
        idx = exhaustive.pair_index(graph, a, b)
        bgr = torch.as_tensor(np.repeat((images[b] * 255.0)[..., None], 3, -1), device=dev)
        for k in range(args.streams):
            gen = incremental.frame_generator(dev, pass_seed, b, k)
            ps, _, _ = incremental.init_from_bootstrap(gen, feats[a], feats[b], bgr, K, cfg,
                                                       return_track0=True)
            pose1 = ps.map.poses[1]
            rot, dirn = exhaustive.pose_disagreement(ps.map.poses[0], pose1, graph.R[idx],
                                                     graph.t[idx])
            g_rot, g_dir = gt_disagreement(sc.Rt, a, b, pose1)
            print(json.dumps({"seed": seed, "pair": [a, b], "stream": k, "rot_deg": rot,
                              "dir_deg": dirn, "gt_rot_deg": g_rot, "gt_dir_deg": g_dir,
                              "graph_gt": gt_disagreement(sc.Rt, a, b, torch.as_tensor(
                                  np.concatenate([graph.R[idx], graph.t[idx][:, None]], 1))),
                              "inliers": int(graph.num_inliers[idx]),
                              "parallax": float(graph.parallax_deg[idx]),
                              "graph_s": graph_s}), flush=True)
    if args.witness:
        witness(config, dev)
    return 0


def witness(config, dev):
    """The sequential bootstrap of the witness pass, and the view graph's
    pair (0, 1) under 8 streams, at the configuration's K and at the
    full-precision K the port's defaults halve."""
    from sfm_mvs_tpu_torch.models import exhaustive, incremental
    from sfm_mvs_tpu_torch.utils.config import SfmConfig

    full = SfmConfig()
    exact = dict(fx=full.fx / 2, fy=full.fy / 2, cx=full.cx / 2, cy=full.cy / 2)
    for label, k in (("config", None), ("full", exact)):
        conf = json.loads(json.dumps(config))
        if k:
            conf["scene"].update(k)
            conf["sfm"].update(k)
        cfg = pipeline.sfm_config(conf)
        K = torch.as_tensor(cfg.intrinsic_matrix(), device=dev)
        sc, images = scene(conf, WITNESS_SEED, dev)
        feats = detect(images[:9], cfg, dev)
        bgr = torch.as_tensor(np.repeat((images[1] * 255.0)[..., None], 3, -1), device=dev)
        gen = pipeline.generator(dev, WITNESS_SEED, 2, WITNESS_PASS)
        ps, _ = incremental.init_from_bootstrap(gen, feats[0], feats[1], bgr, K, cfg)
        pose1 = ps.map.poses[1]
        g_rot, g_dir = gt_disagreement(sc.Rt, 0, 1, pose1)
        rows = []
        for s in range(8):
            graph = exhaustive.build_view_graph(images[:9], cfg, seed=seed_int(WITNESS_SEED, 9, s),
                                                feats=feats, window=cfg.view_graph_window)
            idx = exhaustive.pair_index(graph, 0, 1)
            rows.append(exhaustive.pose_disagreement(ps.map.poses[0], pose1, graph.R[idx],
                                                     graph.t[idx]))
        print(json.dumps({"witness": label, "gt_rot_deg": g_rot, "gt_dir_deg": g_dir,
                          "vs_graph": rows, "K": [cfg.fx, cfg.fy, cfg.cx, cfg.cy]}), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
