"""The calls into the port that the drivers share: its configuration from
a configuration file, the scene on the card, and bench.py's per-frame
loop (detect -> register_frame -> global bundle adjustment).

Every call goes through the port's module attributes at call time
(``sift.detect_and_compute``, ``incremental.register_frame``,
``ba.bundle_adjust_map``), so that a test can break a step underneath.
"""

from __future__ import annotations

import copy
import time
from typing import NamedTuple

import torch

from portbench import scene as scene_mod
from portbench.harness import seed_int, sync


def sfm_config(config: dict):
    """The port's ``SfmConfig`` from a configuration file's ``sfm`` block
    (nested blocks are its sub-configurations)."""
    from sfm_mvs_tpu_torch.utils import config as cfg_mod

    sub = {"frontend": cfg_mod.FrontendConfig, "ransac": cfg_mod.RansacConfig,
           "ba": cfg_mod.BaConfig, "map": cfg_mod.MapConfig, "sweep": cfg_mod.SweepConfig}
    kw = {}
    for key, value in config["sfm"].items():
        kw[key] = sub[key](**value) if key in sub else value
    return cfg_mod.SfmConfig(**kw)


def tiny(config: dict) -> dict:
    """The cut every driver's ``tiny()`` starts from, for the CPU tests:
    240x160 frames with the intrinsics scaled to them, 1024 features and
    256 RANSAC hypotheses. A copy; `config` is left as it is."""
    config = copy.deepcopy(config)
    small = dict(image_size=[240, 160], fx=300.0, fy=301.0, cx=119.0, cy=81.0)
    config["scene"].update(small)
    config["sfm"].update({k: small[k] for k in ("fx", "fy", "cx", "cy")})
    config["sfm"]["frontend"]["max_features"] = 1024
    config["sfm"]["ransac"] = {"essential_iters": 256, "pnp_iters": 256}
    return config


def render(ctx):
    """The configuration's scene with the run's texture, on the card."""
    s = ctx.config["scene"]
    return scene_mod.render(
        num_cameras=s["num_cameras"], image_size=tuple(s["image_size"]), fx=s["fx"], fy=s["fy"],
        cx=s["cx"], cy=s["cy"], radius=s["radius"], arc_degrees=s["arc_degrees"],
        num_strips=s["num_strips"], depth_spread=s["depth_spread"],
        geometry_seed=s["geometry_seed"], texture_seed=seed_int(ctx.seed, 1),
        device=ctx.device)


def stage_u8(images: torch.Tensor) -> torch.Tensor:
    """bench.py's input: the sequence on the card as uint8 (truncated)."""
    return (images * 255.0).to(torch.uint8)


def gray_of(stack8, i):
    return stack8[i].float() / 255.0


def bgr_of(stack8, i):
    return stack8[i][..., None].expand(-1, -1, 3).float()


def generator(device, *words) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_int(*words))
    return gen


class FrameRecord(NamedTuple):
    pass_id: int
    frame: int
    latency_s: float
    accepted: torch.Tensor  # () bool on the device, read after the window


class FrameMaps(NamedTuple):
    """A registered frame's maps, kept for the reference."""

    frame: int
    points_before: torch.Tensor  # () the map's point count before registration
    registered: object  # the MapState register_frame returned (BA's input)
    adjusted: object  # the MapState bundle adjustment returned


class PassRecord(NamedTuple):
    pass_id: int
    frames: int  # frames whose pose the pass produced (the bootstrap's two included)
    map: object  # the pass's last MapState
    ba_cost: object  # () the last BA's reported final cost, or None


class SparseRunner:
    """bench.py's loop, one frame per call, on a staged uint8 sequence."""

    def __init__(self, ctx, stack8, cfg, spans):
        from sfm_mvs_tpu_torch.models import ba, incremental
        from sfm_mvs_tpu_torch.ops import sift

        self.ctx, self.stack8, self.cfg, self.spans = ctx, stack8, cfg, spans
        self.sift, self.inc, self.ba = sift, incremental, ba
        self.K = torch.as_tensor(cfg.intrinsic_matrix(), device=ctx.device)
        b = ctx.config["per_frame_ba"]
        self.ba_iters, self.cg_iters = b["max_iterations"], b["cg_iters"]
        self.ba_event_ms: list[float] = []
        self.keep = False  # keep the next frame's maps for the reference
        self.kept: list = []
        self.last = None  # the last registered frame's maps
        self.pstate = None
        self.ba_cost = None
        self.gen = None

    def detect(self, i):
        with self.spans("detect"):
            return self.sift.detect_and_compute(gray_of(self.stack8, i), self.cfg.frontend)

    def bootstrap(self, gen):
        f0, f1 = self.detect(0), self.detect(1)
        with self.spans("bootstrap"):
            self.pstate, st = self.inc.init_from_bootstrap(
                gen, f0, f1, bgr_of(self.stack8, 1), self.K, self.cfg)
        self.ba_cost = None
        return st.accepted

    def frame(self, gen, i):
        feats = self.detect(i)
        points_before = self.pstate.map.num_points
        with self.spans("register"):
            self.pstate, st = self.inc.register_frame(gen, self.pstate, feats,
                                                      bgr_of(self.stack8, i), self.cfg)
        timed = (self.spans.enabled and not self.spans.profiling
                 and self.ctx.device.type == "cuda")
        if timed:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        with self.spans("ba"):
            mstate, bst = self.ba.bundle_adjust_map(self.pstate.map, max_iterations=self.ba_iters,
                                                    cg_iters=self.cg_iters)
        if timed:
            e1.record()
            e1.synchronize()
            self.ba_event_ms.append(e0.elapsed_time(e1))
        self.last = FrameMaps(i, points_before, self.pstate.map, mstate)
        if self.keep:  # references: the port's map updates are out of place
            self.kept.append(self.last)
        self.pstate = self.pstate._replace(map=mstate)
        self.ba_cost = bst.final_cost
        return st.accepted

    def step(self, pass_id: int, i: int) -> FrameRecord:
        """Frame i of pass `pass_id` (i = 1 is the bootstrap on frames 0
        and 1), synchronized: its latency from the staged frame to its
        pose and map."""
        t = time.perf_counter()
        with self.spans.outer("frame"):
            if i == 1:
                self.gen = generator(self.ctx.device, self.ctx.seed, 2, pass_id)
                acc = self.bootstrap(self.gen)
            else:
                acc = self.frame(self.gen, i)
            sync(self.ctx.device)
        return FrameRecord(pass_id, i, time.perf_counter() - t, acc)

    def record(self, pass_id: int, frames: int) -> PassRecord:
        return PassRecord(pass_id, frames, self.pstate.map, self.ba_cost)
