"""MVS pass 1's CUDA kernels (ops/mvs_cuda.py, csrc/mvs_sweep.cu), what the
CPU can check: the module imports without nvcc or a GPU, CPU tensors take
the plain code bit for bit and launch nothing, the wrappers refuse what
the kernels do not take before building anything, and the host-side
planning of grids and shared memory. The kernels themselves are held to
a float64 plain sweep on the card by ``chip_smoke.py`` (its MVS kernel
check). The library declarations (``ops/cuda_build.Library``) of both
CUDA sources, MVS pass 1's and K1's (``ops/matching_cuda.py``,
``csrc/knn2.cu``), are checked against their sources here too.
"""

import inspect
import re

import pytest
import torch

from sfm_mvs_tpu_torch.models import mvs
from sfm_mvs_tpu_torch.ops import cuda_build, matching_cuda, mvs_cuda
from sfm_mvs_tpu_torch.utils import profiling


def _chunk(rng, B=2, M=2, H=40, W=52):
    """Images and poses of a small batch of references, neighbours close."""
    ref = torch.as_tensor(rng.random((B, H, W)), dtype=torch.float32)
    nbr = torch.as_tensor(rng.random((B, M, H, W)), dtype=torch.float32)
    pose = torch.zeros((B, 3, 4))
    pose[:, :, :3] = torch.eye(3)
    npose = torch.zeros((B, M, 3, 4))
    npose[..., :3] = torch.eye(3)
    npose[..., 0, 3] = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, M)), dtype=torch.float32)
    K = torch.tensor([[60.0, 0.0, W / 2], [0.0, 60.0, H / 2], [0.0, 0.0, 1.0]])
    return ref, nbr, pose, npose, K, torch.full((B,), 3.0), torch.full((B,), 9.0)


def _sweep_args(rng, B=2, M=2, H=40, W=52, D=6):
    ref, nbr, _, _, K, _, _ = _chunk(rng, B, M, H, W)
    R = torch.eye(3).expand(B, M, 3, 3).contiguous()
    t = torch.as_tensor(rng.uniform(-0.3, 0.3, (B, M, 3)), dtype=torch.float32)
    center = torch.as_tensor(rng.uniform(0.1, 0.2, (B, H, W)), dtype=torch.float32)
    offs = torch.linspace(-0.05, 0.05, D).expand(B, D).contiguous()
    extra = (center * 0.9, center * 1.1)
    return ref, nbr, K, R, t, center, offs, extra


@pytest.fixture
def traced():
    profiling.reset()
    profiling.enable()
    yield
    profiling.disable()
    profiling.reset()


def _kernel_count():
    return profiling.summary(profiling.export())["counters"].get("mvs.sweep_kernel", 0)


@pytest.mark.parametrize("mode,dist", [("nearest", None), ("bilinear", None),
                                       ("bilinear", (0.03, -0.01))])
def test_sweep_select_on_cpu_is_the_plain_code(rng, traced, mode, dist):
    ref, nbr, K, R, t, center, offs, extra = _sweep_args(rng)
    d = None if dist is None else torch.tensor(dist)
    ours = mvs._sweep_select(ref, nbr, K, R, t, center, offs, 2, dist=d, sample_mode=mode,
                             extra=extra)
    plain = mvs._sweep_select_plain(ref, nbr, K, R, t, center, offs, 2, dist=d,
                                    sample_mode=mode, extra=extra)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)
    # The unbatched form too.
    one = mvs._sweep_select(ref[0], nbr[0], K, R[0], t[0], center[0], offs[0], 2, dist=d,
                            sample_mode=mode, extra=tuple(e[0] for e in extra))
    for a, b in zip(one, plain):
        assert torch.equal(a, b[0])
    assert _kernel_count() == 0


def test_plane_sweep_batch_on_cpu_is_the_plain_code(rng, traced, monkeypatch):
    args = _chunk(rng, B=3, M=2, H=48, W=64)
    ours = mvs._plane_sweep_batch(*args, num_depths=16)
    monkeypatch.setattr(mvs, "_sweep_select", mvs._sweep_select_plain)
    monkeypatch.setattr(mvs, "_zero_mean", mvs._zero_mean_plain)
    plain = mvs._plane_sweep_batch(*args, num_depths=16)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)
    assert _kernel_count() == 0


def test_zero_mean_on_cpu_is_the_box_filter(rng):
    ref, nbr = _chunk(rng)[:2]
    zr, zn = mvs._zero_mean(ref, nbr, 2)
    assert torch.equal(zr, ref - mvs._box_filter(ref, 2))
    assert torch.equal(zn, nbr - mvs._box_filter(nbr, 2))


def _mvs_refusals(rng):
    ref, nbr, K, R, t, center, offs, extra = _sweep_args(rng)
    return [
        ("CUDA", lambda: mvs_cuda.sweep_select(ref, nbr, K, R, t, center, offs, 2, extra=extra)),
        ("CUDA", lambda: mvs_cuda.zero_mean(ref, nbr, 2)),
        (r"\(B, H, W\)",
         lambda: mvs_cuda.sweep_select(ref[0], nbr[0], K, R[0], t[0], center[0], offs[0], 2)),
        (r"\(B, H, W\)", lambda: mvs_cuda.zero_mean(ref[0], nbr, 2)),
    ]


def _k1_refusals(rng):
    d0 = torch.as_tensor(rng.random((40, 128)), dtype=torch.float32)
    d1 = torch.as_tensor(rng.random((50, 128)), dtype=torch.float32)
    v1 = torch.ones(50, dtype=torch.bool)
    return [
        ("CUDA", lambda: matching_cuda.knn2_raw(d0, d1, v1)),
        ("CUDA", lambda: matching_cuda.knn2_raw(d0[None], d1[None], v1[None])),
        (r"\(N0, D\)", lambda: matching_cuda.knn2_raw(d0[0], d1, v1)),
    ]


@pytest.mark.parametrize("refusals", [_mvs_refusals, _k1_refusals], ids=["mvs", "k1"])
def test_wrappers_refuse_before_building(rng, monkeypatch, refusals):
    """CPU tensors and a missing batch axis raise ValueError at the
    checks, before nvcc is looked for."""
    def no_build(*a, **k):
        raise AssertionError("built")

    monkeypatch.setattr(cuda_build, "compile_library", no_build)
    for match, call in refusals(rng):
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("B,H,W,M,D,grid", [
    (4, 256, 384, 4, 64, (12, 8, 4)),     # the fountain chunk: coarsest level
    (4, 512, 768, 4, 5, (24, 16, 4)),
    (4, 1024, 1536, 4, 3, (48, 32, 4)),   # finest level
    (1, 162, 242, 2, 64, (8, 6, 1)),      # gustav57 at 968x648, coarsest; B = 1
    (1, 33, 31, 3, 5, (1, 2, 1)),         # odd sizes: one ragged tile each way
])
def test_sweep_plan(B, H, W, M, D, grid):
    got, smem = mvs_cuda.sweep_plan(B, H, W, M, D, 2)
    assert got == grid
    assert (grid[0] - 1) * mvs_cuda.TILE < W <= grid[0] * mvs_cuda.TILE
    assert (grid[1] - 1) * mvs_cuda.TILE < H <= grid[1] * mvs_cuda.TILE
    halo = mvs_cuda.TILE + 4
    assert smem == 4 * (6 * halo * halo + 2 * halo * mvs_cuda.TILE + 12 * M + D)
    if (B, H, W) == (4, 256, 384):
        assert smem == 40768  # under the 48 KB a block gets without asking


@pytest.mark.parametrize("images,H,W,radius,grid,smem", [
    (20, 1024, 1536, 2, (48, 32, 20), 9792),  # 4 refs + 16 neighbours
    (3, 162, 242, 2, (8, 6, 3), 9792),
    (2, 5, 7, 0, (1, 1, 2), 4 * (32 * 32 + 32 * 32)),
])
def test_zero_mean_plan(images, H, W, radius, grid, smem):
    assert mvs_cuda.zero_mean_plan(images, H, W, radius) == (grid, smem)


def test_pass1_entry_points_keep_their_names_and_parameters():
    """The benchmark and chip_smoke.py wrap these by module attribute."""
    names = lambda f: list(inspect.signature(f).parameters)  # noqa: E731
    assert names(mvs._plane_sweep_batch) == [
        "ref_b", "nbr_b", "pose_b", "nposes_b", "K", "lo_b", "hi_b", "num_depths",
        "cost_radius", "min_confidence", "coarse_levels", "refine_hyps", "refine_hyps_final",
        "escape_final", "dist"]
    assert names(mvs._depth_ranges) == ["state"]
    assert names(mvs._fuse_batch) == [
        "depth_b", "conf_b", "valid_b", "pose_b", "nbr_depth_b", "nbr_pose_b", "nbr_valid_b",
        "min_cons_b", "K", "color_b", "rel_tol", "stride", "geometric_check", "dist",
        "fuse_depths", "edge_trim_rel", "free_space_rel", "edge_trim_radius", "edge_keep_conf",
        "min_conf", "gray"]
    assert names(mvs._sweep_select) == names(mvs._sweep_select_plain)


def test_ptxas_report_parses_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112sweep_kernelEv' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_112sweep_kernelEv",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z4zeroPf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers",
    ])
    assert cuda_build.ptxas_report(log) == {
        "_ZN12_GLOBAL__N_112sweep_kernelEv": (80, 12), "_Z4zeroPf": (32, 0)}


def _int_constant(src: str, name: str) -> int:
    """The value of the source's ``constexpr int <name>``, its expression
    over other such constants evaluated."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    return eval(re.sub(r"[A-Za-z_]\w*", lambda m: str(_int_constant(src, m.group())), expr))


@pytest.mark.parametrize("module,extra_flags", [(mvs_cuda, ["-fmad=false"]),
                                                (matching_cuda, [])], ids=["mvs", "k1"])
def test_the_kernel_source_and_flags(module, extra_flags):
    """Each CUDA library is built from its csrc/ source for sm_90a with the
    shared flags (MVS pass 1 also without contraction), and its source
    exports what its declaration binds, returning the wrapper's constants."""
    lib = module.LIB
    assert lib.src == module._SRC and lib.src.exists()
    assert lib.flags == cuda_build.NVCC_FLAGS + extra_flags
    assert "arch=compute_90a,code=sm_90a" in lib.flags
    src = lib.src.read_text()
    for name in [*lib.functions, *lib.constants]:
        assert f"{name}(" in src
    for name, want in lib.constants.items():
        returned = re.search(rf"int {name}\(\) {{ return (\w+); }}", src).group(1)
        assert _int_constant(src, returned) == want, name
