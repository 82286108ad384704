"""Offline train -> eval accuracy benchmark, the port's counterpart of the
root ``tools/accuracy_benchmark.py`` (same function names, defaults and
stage order).

No published checkpoint or real OASIS/NYU data is needed: the chain
1. RENDERS a multi-scene dataset with the port's annotator CLI (procedural
   rooms with spheres and boxes, Lambertian shading from two fixed lights
   baked into the vertex colours, so rgb carries the normal cue a scan's
   baked lighting does), on the batched route on a card;
2. TRAINS UNet-normals (config/normal.yml: cos + 10 L1, Adam amsgrad lr
   1e-4, wd 2e-6) at 512², batch 16, and DPT-hybrid-384 depth
   (config/depth.yml, the SSI stage of its loss schedule) at 384², batch
   8, in process with ``--resume``;
3. EVALUATES the held-out scenes with the published suites
   (``eval_normal``; ``eval_depth --align ssi``), untrained and trained,
   and the depth net's share of exactly-zero outputs (it ends in a ReLU);
4. WRITES the numbers to ACCURACY_TORCH.md, beside the JAX package's
   recorded normals rows. ACCURACY.md, the JAX package's record, is never
   written.

Each stage is idempotent: scenes with an ``.annotated`` marker and
trainers with a ``.done`` marker are skipped, and a killed trainer goes on
from its ``last`` checkpoint.

    python -m omnidata_tpu_torch.accuracy_benchmark            # full run, on the card
    python -m omnidata_tpu_torch.accuracy_benchmark --device cpu --train_scenes 1 \\
        --val_scenes 1 --res 64 --edge 1.0 --normal_steps 2 --depth_steps 2 \\
        --normal_batch 2 --depth_batch 2 --root tmp/acc_cpu --out tmp/acc_cpu/ACC.md \\
        --settings FORCE_BATCHED_PATH=1
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_REPORT = os.path.join(REPO, "ACCURACY.md")

# ACCURACY.md's normals rows: the JAX package on a TPU v5 lite, 1500 steps,
# recorded 2026-08-19 (its depth rows were evaluated without alignment, so
# none is comparable with this tool's SSI-aligned rows)
JAX_NORMAL_RECORD = {
    "untrained init": {
        "ang_error_mean": 92.705, "ang_error_median": 91.272, "eval_L1": 68.967,
        "eval_mse": 66.420, "percentage_within_11.25_degrees": 0.002,
        "percentage_within_22.5_degrees": 0.009, "percentage_within_30_degrees": 0.017},
    "trained": {
        "ang_error_mean": 12.116, "ang_error_median": 8.482, "eval_L1": 9.918,
        "eval_mse": 2.795, "percentage_within_11.25_degrees": 0.626,
        "percentage_within_22.5_degrees": 0.872, "percentage_within_30_degrees": 0.923},
}
JAX_RECORD_VIEWS = (700, 140)


def _note(msg: str) -> None:
    print(f"[accuracy] {time.strftime('%H:%M:%S')} {msg}", flush=True)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _vertex_normals_np(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (numpy)."""
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(n, 1e-12)


def make_scene(path: str, seed: int, edge: float = 0.35) -> None:
    """Procedural interior with shaded vertex colours, written as
    path/mesh.ply.

    Albedo varies smoothly with position (a per-scene random sinusoid
    palette); shading = ambient + two directional Lambertian terms on the
    vertex normals. Without it, random vertex colours give an rgb with no
    normal cue and the task is unlearnable by construction."""
    from .mesh import cube, room, split_long_edges, uv_sphere
    from .utils.convert_mesh import write_ply

    rng = np.random.RandomState(seed)
    parts = [room(size=float(rng.uniform(7.0, 10.0)), height=3.0)]
    for _ in range(rng.randint(3, 6)):
        c = (rng.uniform(-3.0, 3.0), rng.uniform(-3.0, 3.0), rng.uniform(0.4, 1.3))
        parts.append(uv_sphere(radius=rng.uniform(0.3, 0.7), center=c,
                               n_lat=32, n_lon=64))
    for _ in range(rng.randint(3, 7)):
        c = (rng.uniform(-3.2, 3.2), rng.uniform(-3.2, 3.2), rng.uniform(0.3, 1.0))
        parts.append(cube(size=rng.uniform(0.4, 1.3), center=c))
    vs, fs, off = [], [], 0
    for p in parts:
        vs.append(p.vertices.numpy())
        fs.append(p.faces[: p.num_faces].numpy() + off)
        off += p.vertices.shape[0]
    v = np.concatenate(vs).astype(np.float32)
    f = np.concatenate(fs)
    v, f, _, _, _, _ = split_long_edges(v, f, edge)
    f = np.asarray(f)

    n = _vertex_normals_np(v, f)
    l1 = np.array([0.45, 0.35, 0.82], np.float32)
    l1 /= np.linalg.norm(l1)
    l2 = np.array([-0.6, -0.55, 0.35], np.float32)
    l2 /= np.linalg.norm(l2)
    shade = (0.25 + 0.55 * np.maximum(n @ l1, 0.0)
             + 0.25 * np.maximum(n @ l2, 0.0))
    freq = rng.uniform(0.5, 2.0, (3, 3)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    albedo = 0.45 + 0.35 * np.sin(v @ freq.T + phase)  # (V,3) in [0.1,0.8]
    colors = np.clip(albedo * shade[:, None], 0.0, 1.0)
    write_ply(os.path.join(path, "mesh.ply"), v, f, vertex_colors=colors)


RENDER_TASKS = ("rgb", "normal", "depth_zbuffer", "mask_valid")


def render_settings(res: int, views_per_dispatch: int, *extra: str):
    """The annotator settings of every scene (``extra`` overrides)."""
    from .annotator.settings import load_settings

    return load_settings([
        f"RESOLUTION={res}",
        # the JAX tool's rule: tile 32 (the bench configuration), down to
        # 16 at smoke resolutions
        f"RASTER_TILE={min(32, max(16, res // 4))}",
        "NUM_POINTS=14",
        "MIN_CAMERA_SPACING=1.2",
        "MAX_VIEWS_PER_POINT=5",
        "MIN_VIEWS_PER_POINT=2",
        "MIN_NONFIXATED_AFTER_PRUNE=0",
        f"VIEWS_PER_DISPATCH={views_per_dispatch}",
        *extra,
    ])


def annotate_scene(path: str, res: int, views_per_dispatch: int,
                   device: torch.device | str, extra_settings=()) -> None:
    """Points, then one device pass for the four training domains, on
    ``device`` (on a card: the batched route, K views a raster launch)."""
    from .annotator.cli import run_device_tasks, run_points

    settings = render_settings(res, views_per_dispatch, *extra_settings)
    run_points(path, settings, device=device)
    run_device_tasks(path, list(RENDER_TASKS), settings, device=device)


def build_dataset(root: str, n_train: int, n_val: int, res: int,
                  views_per_dispatch: int, edge: float,
                  device: torch.device | str, extra_settings=()) -> tuple[str, str]:
    train_root = os.path.join(root, "train")
    val_root = os.path.join(root, "val")
    jobs = [(train_root, f"scene_{i:02d}", i) for i in range(n_train)]
    jobs += [(val_root, f"scene_{i:02d}", 100 + i) for i in range(n_val)]
    for parent, name, seed in jobs:
        d = os.path.join(parent, name)
        marker = os.path.join(d, ".annotated")
        if os.path.exists(marker):
            continue
        os.makedirs(d, exist_ok=True)
        _note(f"scene {name} (seed {seed}): build + annotate")
        make_scene(d, seed, edge)
        annotate_scene(d, res, views_per_dispatch, device, extra_settings)
        with open(marker, "w") as fh:
            fh.write("ok")
    return train_root, val_root


def _write_cfg(path: str, cfg: dict) -> str:
    from .utils.config import dumps

    with open(path, "w") as fh:
        fh.write(dumps(cfg))
    return path


def _train(main, cfg: dict, cfg_path: str, device, note: str) -> str:
    """main(--config_file --resume --device) unless the run's .done marker
    exists (--resume: a killed run goes on from ckpt_dir/last; a no-op on
    a fresh directory) -> the checkpoint directory."""
    ckpt_dir = cfg["checkpoint_dir"]
    done = os.path.join(ckpt_dir, ".done")
    if os.path.exists(done):
        return ckpt_dir
    _note(note)
    main(["--config_file", _write_cfg(cfg_path, cfg), "--resume",
          "--device", str(device)])
    with open(done, "w") as fh:
        fh.write("ok")
    return ckpt_dir


def train_normal_model(root: str, train_root: str, val_root: str,
                       steps: int, res: int, batch: int,
                       device: torch.device | str) -> str:
    from . import train_normal

    cfg = dict(
        model="unet", image_size=res, batch_size=batch, num_workers=4,
        lr=1.0e-4, weight_decay=2.0e-6, max_steps=steps,
        log_step=50, val_step=max(steps // 3, 1), ckpt_step=max(steps // 3, 1),
        save_top_k=2, checkpoint_dir=os.path.join(root, "ckpt_normal"),
        packed_cache=os.path.join(root, "packs"),
        data_paths={"replica": train_root},
        val_data_paths={"replica": val_root},
        train_datasets={"replica": True}, val_datasets={"replica": True},
    )
    return _train(train_normal.main, cfg, os.path.join(root, "normal.yml"), device,
                  f"training UNet-normals: {steps} steps @ bs {batch} {res}^2")


def train_depth_model(root: str, train_root: str, val_root: str,
                      steps: int, batch: int, device: torch.device | str) -> str:
    from . import train_depth

    cfg = dict(
        model="dpt", image_size=384, batch_size=batch, num_workers=4,
        lr=1.0e-5, max_steps=steps,
        log_step=50, val_step=max(steps // 3, 1), ckpt_step=max(steps // 3, 1),
        save_top_k=2, checkpoint_dir=os.path.join(root, "ckpt_depth"),
        packed_cache=os.path.join(root, "packs"),
        data_paths={"replica": train_root},
        val_data_paths={"replica": val_root},
        train_datasets={"replica": True}, val_datasets={"replica": True},
    )
    return _train(train_depth.main, cfg, os.path.join(root, "depth.yml"), device,
                  f"training DPT-depth: {steps} steps @ bs {batch} 384^2 "
                  "(SSI stage of the loss schedule)")


def _best_or_last(ckpt_dir: str) -> str:
    from .train.checkpoints import CheckpointManager

    best = CheckpointManager(ckpt_dir).best()  # a checkpoint name (step_N)
    return os.path.join(ckpt_dir, best) if best else os.path.join(ckpt_dir, "last")


def eval_normal_suite(val_root: str, res: int, checkpoint: str | None,
                      device: torch.device | str) -> dict:
    from . import eval_normal

    argv = ["--data_path", val_root, "--model", "unet",
            "--image_size", str(res), "--device", str(device)]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    with contextlib.redirect_stdout(io.StringIO()):
        return eval_normal.main(argv)


def eval_depth_suite(val_root: str, checkpoint: str | None,
                     device: torch.device | str) -> dict:
    from . import eval_depth

    # --align ssi: the model is trained with the SSI stage of the MiDaS
    # loss, so each prediction is aligned to its ground truth by
    # least-squares scale and shift before the metrics (the MiDaS protocol)
    argv = ["--data_path", val_root, "--image_size", "384", "--align", "ssi",
            "--device", str(device)]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    with contextlib.redirect_stdout(io.StringIO()):
        return eval_depth.main(argv)


def depth_zero_share(val_root: str, checkpoint: str | None,
                     device: torch.device | str, batch_size: int = 8) -> float:
    """The share of exactly-zero depth outputs (the net ends in a ReLU)
    over every pixel of the held-out views, at eval_depth's 384² inputs."""
    from .data.dataset import OmnidataDataset, Options
    from .models import create_model

    model = create_model("depth_dpt_hybrid_384", checkpoint=checkpoint,
                         device=device)
    ds = OmnidataDataset(Options(data_path=val_root,
                                 tasks=("rgb", "depth_zbuffer", "mask_valid"),
                                 image_size=384, random_flip=False))
    zeros = total = 0
    with torch.inference_mode():
        for batch in ds.batches(batch_size, shuffle=False, drop_last=False):
            rgb = torch.from_numpy(batch["rgb"].astype(np.float32)).to(device)
            pred = model(rgb * 2.0 - 1.0)
            zeros += int((pred == 0).sum())
            total += pred.numel()
    return zeros / max(total, 1)


def _count_views(root: str) -> int:
    return sum(len(os.listdir(os.path.join(root, s, "rgb")))
               for s in sorted(os.listdir(root))
               if os.path.isdir(os.path.join(root, s, "rgb")))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.join(REPO, "tmp", "accuracy_torch"))
    p.add_argument("--train_scenes", type=int, default=10)
    p.add_argument("--val_scenes", type=int, default=2)
    p.add_argument("--res", type=int, default=512)
    p.add_argument("--normal_steps", type=int, default=1500)
    p.add_argument("--depth_steps", type=int, default=600)
    p.add_argument("--normal_batch", type=int, default=16)
    p.add_argument("--depth_batch", type=int, default=8)
    p.add_argument("--views_per_dispatch", type=int, default=32)
    p.add_argument("--edge", type=float, default=0.35,
                   help="long-edge split threshold (coarser for CPU smokes)")
    p.add_argument("--skip_depth", action="store_true")
    p.add_argument("--skip_normal", action="store_true",
                   help="depth-only rerun (the report then has no normals table)")
    p.add_argument("--out", default=os.path.join(REPO, "ACCURACY_TORCH.md"))
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--settings", nargs="*", default=[], metavar="KEY=VAL",
                   help="annotator settings over the tool's (e.g. FORCE_BATCHED_PATH=1: "
                        "on the CPU below 512², the per-view route's 8192-candidate "
                        "cap fails as the JAX CLI's does)")
    args = p.parse_args(argv)
    if os.path.abspath(args.out) == JAX_REPORT:
        raise ValueError(f"--out {args.out}: ACCURACY.md is the JAX package's record")

    from .annotator.cli import resolve_device

    device = resolve_device(args.device)
    results: dict = {"device": (gpu_name_and_power_limit() if device.type == "cuda"
                                else "cpu")}
    seconds = results["seconds"] = {}

    def stage(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return out

    os.makedirs(args.root, exist_ok=True)
    t0 = time.perf_counter()
    train_root, val_root = stage(
        "render", build_dataset, args.root, args.train_scenes, args.val_scenes,
        args.res, args.views_per_dispatch, args.edge, device, args.settings)
    results["n_train_views"] = _count_views(train_root)
    results["n_val_views"] = _count_views(val_root)
    _note(f"dataset ready: {results['n_train_views']} train / "
          f"{results['n_val_views']} val views ({seconds['render']:.0f}s)")

    if not args.skip_normal:
        _note("eval: untrained UNet baseline")
        results["normal_untrained"] = stage(
            "eval_normal_untrained", eval_normal_suite, val_root, args.res, None, device)
        ckpt_n = stage("train_normal", train_normal_model, args.root, train_root,
                       val_root, args.normal_steps, args.res, args.normal_batch, device)
        _note("eval: trained UNet-normals")
        results["normal_trained"] = stage(
            "eval_normal_trained", eval_normal_suite, val_root, args.res,
            _best_or_last(ckpt_n), device)
        results["normal_steps"] = args.normal_steps

    if not args.skip_depth:
        _note("eval: untrained DPT baseline")
        results["depth_untrained"] = stage(
            "eval_depth_untrained", eval_depth_suite, val_root, None, device)
        results["depth_untrained_zero_share"] = stage(
            "zero_share_untrained", depth_zero_share, val_root, None, device)
        ckpt_d = stage("train_depth", train_depth_model, args.root, train_root,
                       val_root, args.depth_steps, args.depth_batch, device)
        _note("eval: trained DPT-depth")
        best_d = _best_or_last(ckpt_d)
        results["depth_trained"] = stage(
            "eval_depth_trained", eval_depth_suite, val_root, best_d, device)
        results["depth_trained_zero_share"] = stage(
            "zero_share_trained", depth_zero_share, val_root, best_d, device)
        results["depth_steps"] = args.depth_steps
    seconds["total"] = time.perf_counter() - t0

    write_report(args.out, args, results)
    print(json.dumps(results, indent=2, default=float))
    _note(f"done in {seconds['total']:.0f}s -> {args.out}")
    return results


def report_rows(text: str) -> dict:
    """(a table section's first word, model) -> the row's numbers, for every
    row of every table in a report write_report (or the JAX tool) wrote."""
    rows, section = {}, None
    for line in text.splitlines():
        if line.startswith("## "):
            section = line.split()[1]
        elif line.startswith("| ") and not line.startswith("| model"):
            cells = [c.strip() for c in line.strip("|").split("|")]
            rows[(section, cells[0])] = [float(c) for c in cells[1:]]
    return rows


def _table(rows: dict, keys: list) -> list:
    def cell(d, k):
        v = d.get(k)
        return f"{v:.3f}" if isinstance(v, float) else str(v if v is not None else "—")

    return (["| model | " + " | ".join(keys) + " |", "|---|" + "---|" * len(keys)]
            + [f"| {name} | " + " | ".join(cell(d, k) for k in keys) + " |"
               for name, d in rows.items()])


def write_report(path: str, args, r: dict) -> None:
    cmd = "python -m omnidata_tpu_torch.accuracy_benchmark"
    defaults = {"train_scenes": 10, "val_scenes": 2, "res": 512, "normal_steps": 1500,
                "depth_steps": 600, "normal_batch": 16, "depth_batch": 8,
                "views_per_dispatch": 32, "edge": 0.35, "device": "cuda"}
    cmd += "".join(f" --{k} {getattr(args, k)}" for k, v in defaults.items()
                   if getattr(args, k) != v)
    cmd += "".join(f" --{k}" for k in ("skip_depth", "skip_normal") if getattr(args, k))
    if args.settings:
        cmd += " --settings " + " ".join(args.settings)
    s = r["seconds"]
    lines = [
        "# ACCURACY_TORCH — offline train->eval benchmark of the PyTorch port",
        "",
        "The PyTorch port's counterpart of ACCURACY.md (the JAX package's",
        "record, which this tool never writes): render a dataset with the",
        "port's annotator, train with the reference's hyperparameters,",
        "evaluate held-out scenes with the published metric suites",
        "(train/metrics; the numbers the OASIS table reports for normals).",
        "",
        "Reproduce with one command (idempotent; deletes nothing):",
        "",
        f"    {cmd}",
        "",
        f"- dataset: {args.train_scenes} train / {args.val_scenes} held-out "
        f"procedural scenes (seeds 0.. and 100..), {r['n_train_views']} / "
        f"{r['n_val_views']} views at {args.res}^2, long edges split at "
        f"{args.edge} m (the JAX record: {JAX_RECORD_VIEWS[0]} / "
        f"{JAX_RECORD_VIEWS[1]})",
        f"- device: {r['device']}",
        "- seconds by stage (this invocation; a stage found done costs ~0): "
        + ", ".join(f"{k} {v:.1f}" for k, v in s.items()),
    ]
    if "normal_trained" in r:
        nk = sorted(r["normal_trained"])
        lines += [
            "",
            "## Surface normals — UNet (config/normal.yml hyperparameters, "
            f"{r.get('normal_steps')} steps, batch {args.normal_batch})",
            "",
            *_table({"untrained init": r["normal_untrained"],
                     "trained": r["normal_trained"],
                     "JAX record, untrained init (TPU v5 lite, 2026-08-19)":
                         JAX_NORMAL_RECORD["untrained init"],
                     "JAX record, trained 1500 steps (TPU v5 lite, 2026-08-19)":
                         JAX_NORMAL_RECORD["trained"]}, nk),
            "",
            "(ang_* in degrees, lower better; percentage_* higher better. The",
            "JAX rows are ACCURACY.md's, another package on another device and",
            "its own seeded initialisation; the same chain and hyperparameters.)",
        ]
    if "depth_trained" in r:
        dk = sorted(r["depth_trained"])
        lines += [
            "",
            "## Depth — DPT-hybrid-384 (config/depth.yml hyperparameters, "
            f"{r.get('depth_steps')} steps, batch {args.depth_batch}, SSI stage; "
            "eval per-image scale/shift-aligned, the MiDaS protocol)",
            "",
            *_table({"untrained init": r["depth_untrained"],
                     "trained": r["depth_trained"]}, dk),
            "",
            "- share of exactly-zero depth outputs on the held-out views (every "
            f"pixel at 384²): untrained {r['depth_untrained_zero_share']:.6f}, "
            f"trained {r['depth_trained_zero_share']:.6f}",
            "- ACCURACY.md's depth rows were evaluated without alignment, so no",
            "  JAX depth row is comparable with these.",
        ]
    lines += [
        "",
        f"Recorded {time.strftime('%Y-%m-%d %H:%M')} by "
        "omnidata_tpu_torch/accuracy_benchmark.py.",
        "",
    ]
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


if __name__ == "__main__":
    main()
