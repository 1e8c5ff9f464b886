"""k1_roofline: K1's share of its roofline in the profiled stretch, in %.

The least time the launches could take at the H100's published peaks
(FP32 67 TFLOP/s, HBM 3.35 TB/s; ``roofline.k1_bound_s``, counting each
launch's valid rows and columns only) over the device time of the
kernel's ops (names containing ``knn2``) in the torch.profiler trace.
None where the stretch launched no K1."""

from portbench import roofline


def read(data):
    t = sum(v for k, v in data.kernels.items() if "knn2" in k)
    if not data.k1_launches or not t > 0.0:
        return None
    bound, _ = roofline.k1_bound_s(data.k1_launches)
    return roofline.share_percent(bound, t)
