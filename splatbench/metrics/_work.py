"""The work a render or a training step needs, whatever implements it,
and the least time an H100 could take for it.

Counts are taken by the benchmark from the cell's own inputs (the
reference's contributing pairs, intersections and visible gaussians of
each pose), never from a kernel's own walk, so that no kernel moves its own
yardstick:

  - a blend does work only for the (pixel, gaussian) pairs that contribute:
    alpha >= alpha_threshold before the pixel's transmittance falls below
    transmittance_eps;
  - each input is read once and each output written once;
  - peaks are NVIDIA's for one H100 SXM at its 700 W limit.
"""

from __future__ import annotations

# HBM bytes/s, f32 operations/s outside the tensor cores, and exponentials/s
# of the special-function units: 16 per clock per SM (the arithmetic
# throughput table for compute capability 9.0) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S, F32_OPS_PER_S, SFU_EXP_PER_S = 3.35e12, 67e12, 16 * 132 * 1.98e9

# f32 operations and exponentials per contributing pair. 3DGS forward:
# the alpha (15, one exp), the T update (2), the weight (1), 4 channels'
# accumulate (8). Its adjoint: the alpha and T again (17), d alpha, the 6
# geometry and 4 channel gradients and their pixel sums (~48). 2DGS
# forward: the 2x2 ray / disk system (12), its determinant and solve (10),
# s^2 and the low-pass filter (9), max, opacity and clamp (4), the keep
# test (1), T (2), weight (1), 4 channels (8); with the maps two more
# channels (4), the depth (4) and its two moments (4). Its adjoint with the
# maps: the alpha and T again (~48), d alpha and the carry (6), 6
# channels and the moments (16), the branch and filter terms (8), the
# solve's adjoint (24), the depth chain (12), 18 rows of pixel sums (18).
PAIR = {
    ("3dgs", "fwd", False): (25, 1), ("3dgs", "bwd", False): (65, 1),
    ("2dgs", "fwd", False): (48, 2), ("2dgs", "fwd", True): (60, 2),
    ("2dgs", "bwd", True): (132, 2),
}
# f32 values a blend reads per (tile, gaussian) pair, and per pixel writes
# (forward) or reads (adjoint: the cotangents and the transmittance):
# 3DGS a centre, a conic, an opacity and 3 colours; 2DGS the camera-frame
# centre and two scaled axes, the projected centre, an opacity, 3 colours
# and, with the maps, a normal.
SLOT_VALUES = {("3dgs", False): 9, ("2dgs", False): 15, ("2dgs", True): 18}
PIXEL_VALUES = {("3dgs", False): 4, ("2dgs", False): 4, ("2dgs", True): 9}

# Per visible gaussian, forward and adjoint: SH degree 3 (direction and
# its normalisation 12, the 16 basis terms 40, 48 multiply-adds 96, offset
# and floor 6; adjoint 224); the EWA projection (quaternion normalisation
# and rotation 39, R S and Sigma 42, the camera frame 75, the Jacobian and
# the 2D covariance 35, dilation, determinant and conic 10, the radius
# and culling 22; adjoint 420); 2DGS's columns (camera-frame centre and
# axes 60, the projected centre 8, the normal 22; adjoint 180) beside the
# flattened EWA projection that bins it.
SH_OPS = (154, 224)
EWA_OPS = (223, 420)
SURFEL_OPS = (90, 180)
PARAMS = {"3dgs": 59, "2dgs": 58}  # f32 values of a gaussian's raw parameters
# Adam per parameter: both moments (7), the bias corrections, root and eps
# (4), the update (3); reading parameter, gradient and moments and writing
# parameter and moments.
ADAM_OPS, ADAM_BYTES = 14, 28


def blend(family: str, way: str, maps: bool, pairs: float, isects: float, pixels: float):
    """(f32 operations, exponentials, bytes) of one blend pass."""
    ops, exps = PAIR[(family, way, maps)]
    slot = SLOT_VALUES[(family, maps)] * 4 * isects
    pix = PIXEL_VALUES[(family, maps)] * 4 * pixels
    nbytes = slot + pix if way == "fwd" else 2 * slot + pix
    return ops * pairs, exps * pairs, nbytes


def kernel_bound_s(ops: float, exps: float, nbytes: float) -> float:
    """The least time a kernel could take: its operations at the f32 peak,
    its exponentials at the special-function units' peak, or its bytes at
    the HBM peak, whichever is longest."""
    return max(ops / F32_OPS_PER_S, exps / SFU_EXP_PER_S, nbytes / HBM_BYTES_PER_S)


def gaussian_ops(family: str, train: bool) -> float:
    """f32 operations per visible gaussian outside the blend."""
    way = 1 if train else 0
    ops = SH_OPS[0] + EWA_OPS[0]
    if family == "2dgs":
        ops += SURFEL_OPS[0]
    if train:
        ops += SH_OPS[way] + (SURFEL_OPS[way] if family == "2dgs" else EWA_OPS[way])
        ops += PARAMS[family] * ADAM_OPS
    return ops


def unit_bound_s(family: str, train: bool, w: dict) -> float:
    """The least time of one whole step (``train``) or frame at one pose's
    counts ``w`` (pairs, isects, visible, H, W): all its f32 operations at
    the f32 peak or all its bytes at the HBM peak, whichever is longer."""
    maps = train and family == "2dgs"
    pixels = w["H"] * w["W"]
    ops, _, nbytes = blend(family, "fwd", maps, w["pairs"], w["isects"], pixels)
    ops += gaussian_ops(family, train) * w["visible"]
    if train:
        b_ops, _, b_bytes = blend(family, "bwd", maps, w["pairs"], w["isects"], pixels)
        ops += b_ops
        nbytes += b_bytes + PARAMS[family] * ADAM_BYTES * w["visible"] + 3 * 4 * pixels
    else:
        nbytes += PARAMS[family] * 4 * w["visible"]
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def kernel_share(ctx: dict, family: str, kind: str, way: str, maps: bool, fragment: str):
    """Per cent of a blend kernel's device time in the traced window that
    its bound needs, or None where the cell runs no such kernel."""
    if ctx["family"] != family or ctx["kind"] != kind:
        return None
    t = ctx["kernel_seconds"](fragment)
    if t <= 0:
        return None
    bound = 0.0
    for w in ctx["work"]:
        ops, exps, nbytes = blend(family, way, maps, w["pairs"], w["isects"], w["H"] * w["W"])
        bound += w["units"] * kernel_bound_s(ops, exps, nbytes)
    return 100.0 * bound / t


def mfu(ctx: dict, kind: str):
    """Per cent of the window's time a unit that the bound of all its work
    needs, or None in another kind of cell."""
    if ctx["kind"] != kind or not ctx["units"]:
        return None
    train = kind == "train"
    bound = sum(w["units"] * unit_bound_s(ctx["family"], train, w) for w in ctx["work"])
    return 100.0 * bound / ctx["window_s"]
