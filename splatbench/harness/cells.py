"""The two kinds of cell, each built from a configuration and a mix.

A cell sets up (scene, program objects, warm-up and, for training, the
first checked steps), runs its window, and then checks what the window's
path produced against the plain reference, after the program's state is
freed. ``units`` are steps or frames.
"""

from __future__ import annotations

import hashlib
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..reference import render as ref
from . import program, traffic
from .scene import load_scene, perturbed
from .spec import CHECKOUT, Spec

CACHE = CHECKOUT / "build" / "splatbench"


def ref_view(pose: dict, dev) -> ref.View:
    return ref.View(torch.as_tensor(pose["R"], device=dev), torch.as_tensor(pose["T"], device=dev),
                    float(pose["fx"]), float(pose["fy"]), float(pose["cx"]), float(pose["cy"]),
                    int(pose["H"]), int(pose["W"]), float(pose["near"]), float(pose["far"]))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel_l2(got, want) -> float:
    """||got - want|| / ||want||; infinite where the shapes differ."""
    if got.shape != want.shape:
        return float("inf")
    return float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))


def norm_gaps(got: dict, want: dict, keys) -> list[float]:
    """Each leaf's |norm(got) - norm(want)|, over the larger of that leaf's
    reference norm and the median leaf's."""
    med = float(np.median([want[k] for k in want]))
    return [abs(got[k] - want[k]) / max(want[k], med) for k in keys]


class Cell:
    kind = ""

    def __init__(self, spec: Spec, seed: int, dev):
        t = time.perf_counter()
        self.spec, self.seed, self.dev = spec, seed, dev
        self.config, self.mix = spec.config, spec.traffic
        self.family = self.config["family"]
        self.sh_degree = self.config["sh_degree"]
        self.rules = ref.Rules.of(self.config["render"])
        self.tally = program.Tally(dev)
        self.scene_path = CHECKOUT / self.config["scene"]["file"]
        self.raw = load_scene(self.scene_path, self.family, dev,
                              self.config["scene"].get("every", 1))
        self.marks = {"scene": time.perf_counter() - t}  # seconds of each set-up part
        self.cfg = program.render_config(self.config)
        self.pkg, self.train = program.port()
        self.units_log: list[int] = []  # grid pose of each window unit

    def drops(self) -> tuple[int, int]:
        return self.tally.read()


class TrainCell(Cell):
    """Training steps through ``train.train_step`` (3DGS) or
    ``train.train_step_surfel`` (2DGS), one view a step, with Adam."""

    kind = "train"

    def __init__(self, spec: Spec, seed: int, dev):
        super().__init__(spec, seed, dev)
        mix = self.mix
        self.grid = traffic.view_grid_ids(mix)
        self.poses = [traffic.pose(mix, k) for k in self.grid]
        self.cams = [program.camera(p, dev) for p in self.poses]
        t = time.perf_counter()
        self.targets = self._targets()
        self.marks["targets"] = time.perf_counter() - t
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.theta0 = perturbed(self.raw, mix["perturb"], gen)
        self.leaves = {k: v.clone().requires_grad_(True) for k, v in self.theta0.items()}
        t = time.perf_counter()
        self.opt = self.train.make_optimizer(self.leaves, lr=mix["optimizer"]["lr"])
        self.marks["optimizer"] = time.perf_counter() - t
        self.order = traffic.TrainOrder(mix, seed)
        self.loss_w = self.config.get("loss", {})
        self.steps = spec.checks["checked_steps"]  # the first steps, checked
        self.checked: dict = {}

    def _targets(self):
        """The capture's images: the unperturbed scene rendered by the
        plain reference, cached once per checkout."""
        h = hashlib.sha256()
        keys = ("height", "width", "ring", "yaw_step_deg", "views")
        for part in (repr(self.rules), self.family, repr(self.sh_degree),
                     repr(self.config["scene"]), repr([self.mix[k] for k in keys]),
                     self.scene_path.read_bytes(), Path(ref.__file__).read_bytes()):
            h.update(part if isinstance(part, bytes) else part.encode())
        path = CACHE / "targets" / f"{self.spec.cell['config']}.{self.spec.cell['traffic']}.{h.hexdigest()[:16]}.pt"
        if path.exists():
            return torch.load(path, map_location=self.dev)
        imgs = torch.stack([
            ref.render(self.family, self.raw, ref_view(p, self.dev), self.rules, self.sh_degree,
                       (0.0, 0.0, 0.0)).maps["rgb"] for p in self.poses])
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        torch.save(imgs.cpu(), tmp)
        os.replace(tmp, path)
        return imgs

    def step(self, view: int):
        cam, tgt = [self.cams[view]], self.targets[view][None]
        if self.family == "3dgs":
            loss = self.train.train_step(self.leaves, self.opt, cam, tgt,
                                         sh_degree=self.sh_degree, config=self.cfg)
        else:
            loss = self.train.train_step_surfel(
                self.leaves, self.opt, cam, tgt, sh_degree=self.sh_degree, config=self.cfg,
                normal_weight=self.loss_w["normal_weight"],
                distortion_weight=self.loss_w["distortion_weight"])
        return loss

    def setup(self) -> None:
        """The first ``self.steps`` steps (the checks file's
        ``checked_steps``), each through the window's own call: their
        losses, the first gradient as Adam got it, and the parameters'
        change after them are kept for the check."""
        losses, views = [], []
        b1 = self.opt.defaults["betas"][0]
        with program.counted(self.tally):
            for s in range(self.steps):
                v = self.order.next()
                self.tally.keep = s == 0
                losses.append(self.step(v))
                self.tally.keep = False
                views.append(v)
                if s == 0:  # a step that left no state has taken no gradient
                    g1 = {k: torch.linalg.norm(self.opt.state[p].get("exp_avg", torch.zeros(())))
                          / (1 - b1) for k, p in self.leaves.items()}
        delta = {k: torch.linalg.norm(p.detach() - self.theta0[k]) for k, p in self.leaves.items()}
        self.checked = dict(views=views, losses=losses, g1=g1, delta=delta,
                            first=self.tally.kept[0])
        self.tally.kept = []

    def window(self, seconds: float) -> dict:
        n = 0
        with program.counted(self.tally):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                v = self.order.next()
                self.step(v)
                self.units_log.append(self.grid[v])
                n += 1
            sync(self.dev)
            t1 = time.perf_counter()
        return dict(units=n, window_s=t1 - t0)

    def free(self) -> None:
        """Keep the checked readings as numbers; drop the program's state."""
        c = self.checked
        out, aux = c["first"]
        self.readings = dict(
            views=c["views"], losses=[float(x) for x in c["losses"]],
            g1={k: float(v) for k, v in c["g1"].items()},
            delta={k: float(v) for k, v in c["delta"].items()},
            isects=int(aux.binning.num_isects))
        if self.family == "2dgs":
            # train.surfel_loss renders image, depth, normals, distortion.
            self.maps = {"depth": out[1].detach(), "normals": out[2].detach(),
                         "distortion": out[3].detach()}
        del self.leaves, self.opt, self.checked
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def loss_fn(self):
        if self.family == "3dgs":
            return ref.l2_loss
        w = self.loss_w
        return lambda m, t, v: ref.surfel_loss(m, t, v, w["normal_weight"], w["distortion_weight"])

    def reference(self, dtype=torch.float32, plant=None) -> dict:
        """The reference's readings of the checked steps, from the same
        start, views and targets, computed in ``dtype``."""
        theta = {k: v.to(dtype) for k, v in self.theta0.items()}
        adam = ref.Adam(self.mix["optimizer"]["lr"])
        rules = self.rules
        out: dict = dict(losses=[])
        for s, v in enumerate(self.readings["views"]):
            view = ref_view(self.poses[v], self.dev).to(dtype)
            tgt = self.targets[v].to(dtype)
            loss_fn = self.loss_fn() if plant is None else plant(self.loss_fn())
            L, g, r = ref.loss_and_grads(self.family, theta, view, tgt, rules, self.sh_degree,
                                         loss_fn, maps=self.family == "2dgs")
            out["losses"].append(float(L))
            if s == 0:
                out["g1"] = {k: float(torch.linalg.norm(x.double())) for k, x in g.items()}
                out["isects"] = r.num_isects
                out["maps"] = r.maps
            theta = adam.step(theta, g)
        out["delta"] = {k: float(torch.linalg.norm((theta[k] - self.theta0[k].to(dtype)).double()))
                        for k in theta}
        return out

    def compare(self, got: dict, want: dict) -> dict:
        g1 = want["g1"]
        med = float(np.median(list(g1.values())))
        moved = [k for k in g1 if g1[k] >= 1e-3 * med]
        grad = norm_gaps(got["g1"], g1, g1.keys())
        nums = dict(
            loss_rel_gap=max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
            grad_norm_gap=max(grad),
            grad_norm_gap_median_leaf=float(np.median(grad)),
            update_norm_gap=max(norm_gaps(got["delta"], want["delta"], moved)),
            isects_rel_gap=abs(got["isects"] - want["isects"]) / max(want["isects"], 1),
        )
        if self.family == "2dgs":
            nums["maps_rel_l2"] = max(rel_l2(got["maps"][k].to(want["maps"][k].dtype), want["maps"][k])
                                      for k in ("depth", "normals", "distortion"))
        return nums

    def check(self) -> dict:
        got = dict(self.readings)
        if self.family == "2dgs":
            got["maps"] = self.maps
        self.want = self.reference()
        return self.compare(got, self.want)

    def work_poses(self) -> dict:
        """Grid pose -> how many window units rendered it."""
        out: dict = {}
        for k in self.units_log:
            out[k] = out.get(k, 0) + 1
        return out

    def work_params(self) -> dict:
        return self.theta0


class OrbitCell(Cell):
    """A viewer's closed loop: the next frame is asked for when the last
    one is synchronised, the pose advancing around the ring."""

    kind = "orbit"

    def __init__(self, spec: Spec, seed: int, dev):
        super().__init__(spec, seed, dev)
        with torch.no_grad():
            self.params = dict(self.raw)
            self.params["opacities"] = torch.sigmoid(self.params.pop("opacities_raw"))
        self.k = traffic.orbit_start(self.mix, seed)
        self.rng = np.random.default_rng([seed, 1])
        self.sample: list = []
        self.latency: list[float] = []

    def frame(self, k: int):
        cam = program.camera(traffic.pose(self.mix, k), self.dev)
        p = self.params
        args = (p["means3d"], p["scales"], p["quats"], p["opacities"], p["features"], cam)
        fn = self.pkg.render_gaussians if self.family == "3dgs" else self.pkg.render_surfels
        img, aux = fn(*args, sh_degree=self.sh_degree, config=self.cfg, return_aux=True)
        self.tally.add(img, aux)
        return img, aux

    def setup(self) -> None:
        """Warm-up: three frames on the poses before the start."""
        with torch.no_grad():
            for j in (3, 2, 1):
                self.frame(self.k - j)
        self.tally = program.Tally(self.dev)  # the warm-up frames count for nothing

    def window(self, seconds: float) -> dict:
        n, size = 0, self.mix["sample_frames"]
        with torch.no_grad():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                t = time.perf_counter()
                k = self.k + n
                img, aux = self.frame(k)
                sync(self.dev)
                self.latency.append(time.perf_counter() - t)
                self.units_log.append(k % traffic.grid_size(self.mix))
                # A uniform sample of the window's frames, drawn from the seed.
                if n < size:
                    self.sample.append((k, img, aux))
                else:
                    j = int(self.rng.integers(n + 1))
                    if j < size:
                        self.sample[j] = (k, img, aux)
                n += 1
            t1 = time.perf_counter()
        return dict(units=n, window_s=t1 - t0)

    def free(self) -> None:
        self.readings = [(k, img, aux.raster.final_transmittance, int(aux.binning.num_isects))
                         for k, img, aux in self.sample]
        del self.sample, self.params
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, k: int, dtype=torch.float32) -> ref.Render:
        raw = {key: v.to(dtype) for key, v in self.raw.items()}
        view = ref_view(traffic.pose(self.mix, k), self.dev).to(dtype)
        return ref.render(self.family, raw, view, self.rules, self.sh_degree, (0.0, 0.0, 0.0))

    def compare_frame(self, img, T, isects, want: ref.Render) -> dict:
        return dict(image_rel_l2=rel_l2(img.to(want.maps["rgb"].dtype), want.maps["rgb"]),
                    T_rel_l2=rel_l2(T.to(want.maps["T"].dtype), want.maps["T"]),
                    isects_rel_gap=abs(isects - want.num_isects) / max(want.num_isects, 1))

    def check(self) -> dict:
        worst: dict = {}
        for k, img, T, isects in self.readings:
            for name, v in self.compare_frame(img, T, isects, self.reference(k)).items():
                worst[name] = max(worst.get(name, 0.0), v)
        return worst

    def work_poses(self) -> dict:
        """Grid pose -> window frames it stands for: ``trace_poses`` poses
        spread evenly over the window's frames, each standing for its share
        (neighbouring frames differ by one step of yaw)."""
        log = self.units_log
        m = min(self.mix["trace_poses"], len(log))
        picks = [log[int((i + 0.5) * len(log) / m)] for i in range(m)]
        out: dict = {}
        for k in picks:
            out[k] = out.get(k, 0) + len(log) / m
        return out

    def work_params(self) -> dict:
        return self.raw


KINDS = {"train": TrainCell, "orbit": OrbitCell}


def build(spec: Spec, seed: int, dev, plant=None) -> Cell:
    """The cell of ``spec`` for ``seed``; ``plant(cell)``, if given, puts a
    fault in its timed path (the harness's own tests)."""
    cell = KINDS[spec.traffic["kind"]](spec, seed, dev)
    if plant is not None:
        plant(cell)
    return cell


def pose_work(cell: Cell) -> list[dict]:
    """For each grid pose the window rendered (or a sample of them), the
    reference's count of contributing (pixel, gaussian) pairs, its
    intersections and visible gaussians at the cell's start parameters,
    and the window units it stands for."""
    out = []
    for k, units in cell.work_poses().items():
        view = ref_view(traffic.pose(cell.mix, k), cell.dev)
        r = ref.render(cell.family, cell.work_params(), view, cell.rules, cell.sh_degree,
                       (0.0, 0.0, 0.0))
        with torch.no_grad():
            p = ref.activate(cell.work_params())
            if cell.family == "2dgs":
                n = p["means3d"].shape[0]
                flat = torch.cat([p["scales"][:, :2], torch.full((n, 1), ref.FLAT_LOG_SCALE,
                                                                 device=cell.dev)], -1)
            else:
                flat = p["scales"]
            s = ref.ewa_project(p["means3d"], flat, p["quats"], p["opacities"], view, cell.rules)
        out.append(dict(pose=k, units=units, pairs=r.pairs, isects=r.num_isects,
                        visible=int((s.radii[:, 0] > 0).sum()), H=view.H, W=view.W))
    return out

