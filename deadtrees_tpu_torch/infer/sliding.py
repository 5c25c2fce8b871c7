"""Sliding-window scene prediction with stitching on the device.

Counterpart of ``deadtrees_tpu.infer.sliding``. One padded scene (or a
stack of them) goes to the device as uint8 and comes back as a class map:

    uint8 scenes (S, TH, TW, C) → subtile blocks, scene-major → zero-padded
    to a multiple of ``batch_size`` → per chunk: normalize, the plain
    model, argmax of the logits → validity mask → inverse blocks →
    (S, TH, TW) class map [→ 2-bit pack]

The chunks run one after another, so peak activation memory is one
chunk's; every chunk has one shape. Invalid (padding) subtiles come out
zero. ``predict_scenes`` keeps at most two dispatches in flight, so one
group's host work (Tiler pad copies, staging, 2-bit unpack) overlaps the
next group's forward on the device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deadtrees_tpu_torch.data.augment import normalize
from deadtrees_tpu_torch.data.config import DATASET_CONFIG
from deadtrees_tpu_torch.infer.blocks import make_blocks_nhwc, unmake_blocks_nhwc
from deadtrees_tpu_torch.infer.engine import resolve_device
from deadtrees_tpu_torch.infer.packing import pack2, unpack2
from deadtrees_tpu_torch.infer.tiler import Tiler

Device = Optional[Union[str, torch.device]]


def _on_device(model: torch.nn.Module, device: torch.device) -> bool:
    here = next(model.parameters()).device
    return here.type == device.type and (
        device.index is None or here.index is None or here.index == device.index
    )


def make_scene_predictor(
    model: torch.nn.Module,
    *,
    subtile: int = 512,
    batch_size: int = 128,
    mean: Sequence[float] = DATASET_CONFIG.mean,
    std: Sequence[float] = DATASET_CONFIG.std,
    packed: bool = False,
    tta: int = 0,
    device: Device = None,
) -> Callable:
    """Build ``predict(scene_u8, valid) -> class map`` for ``model`` (an
    eval-mode module on ``device``: CUDA unless ``device="cpu"`` is asked
    for; raises without CUDA, and when the model lies elsewhere).

    ``scene_u8`` is one scene (TH, TW, C) or a scene batch (S, TH, TW, C),
    uint8 (a tensor, moved to the device if it is not there, or numpy),
    with ``valid`` (N,) / (S, N) marking the subtiles that hold data. One
    2048² scene has only 16 subtiles of 512², so a throughput driver feeds
    several scenes per call (``predict_scenes`` does): all scenes' subtiles
    run through shared ``batch_size`` chunks. ``tta`` (4 or 8) takes the
    argmax of the mean probabilities over the dihedral views.

    ``packed=True`` returns the 2-bit packed map (``packing.pack2``,
    (…, TH, TW // 4) uint8): 4× less device→host transfer.

    The JAX predictor's ``mesh`` (the subtile batch sharded over chips) is
    not ported: this runs on one device (ROADMAP.md)."""
    device = resolve_device(device)
    if not _on_device(model, device):
        raise ValueError(
            f"the model lies on {next(model.parameters()).device}, not on {device}"
        )

    def logits_nhwc(img_nhwc: torch.Tensor) -> torch.Tensor:
        return model(img_nhwc.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)

    if tta:
        from deadtrees_tpu_torch.infer.tta import make_tta_fn

        tta_fn = make_tta_fn(logits_nhwc, tta)

    @torch.no_grad()
    def predict(scene_u8, valid):
        scene = torch.as_tensor(scene_u8).to(device, non_blocking=True)
        valid = torch.as_tensor(valid).to(device, non_blocking=True)
        squeeze = scene.ndim == 3
        if squeeze:
            scene, valid = scene[None], valid[None]
        ns, th, tw, c = scene.shape
        m, s = tuple(mean)[:c], tuple(std)[:c]

        blocks = torch.cat([make_blocks_nhwc(sc, subtile) for sc in scene])
        n = blocks.shape[0] // ns  # subtiles per scene
        pad = (-(ns * n)) % batch_size
        if pad:
            blocks = torch.cat([blocks, blocks.new_zeros((pad,) + blocks.shape[1:])])
        preds = torch.empty(blocks.shape[:3], dtype=torch.uint8, device=device)
        for i in range(0, blocks.shape[0], batch_size):
            img = normalize(blocks[i:i + batch_size].float(), m, s)
            if tta:
                scores = tta_fn(img)
            else:
                scores = logits_nhwc(img)
            preds[i:i + batch_size] = scores.argmax(-1)
        del blocks
        preds = preds[: ns * n] * valid.reshape(-1, 1, 1).to(torch.uint8)
        out = torch.stack([
            unmake_blocks_nhwc(p, th, tw) for p in preds.reshape(ns, n, subtile, subtile)
        ])
        if packed:
            out = pack2(out)
        return out[0] if squeeze else out

    return predict


def predict_scene(
    model: torch.nn.Module,
    scene: np.ndarray,
    *,
    tile_shape: Tuple[int, int] = (2048, 2048),
    subtile: int = 512,
    batch_size: int = 128,
    predictor: Optional[Callable] = None,
    mean: Sequence[float] = DATASET_CONFIG.mean,
    std: Sequence[float] = DATASET_CONFIG.std,
    tta: int = 0,
    device: Device = None,
) -> np.ndarray:
    """(H, W, C) uint8 scene → (H, W) class map (cropped), through the
    packed predictor and a host unpack. Runs on CUDA unless
    ``device="cpu"``; raises without CUDA."""
    device = resolve_device(device)
    tiler = Tiler(tile_shape=tile_shape, subtile_shape=(subtile, subtile))
    tiler.load_array(scene)
    fn = predictor or make_scene_predictor(
        model, subtile=subtile, batch_size=batch_size, mean=mean, std=std,
        packed=True, tta=tta, device=device,
    )
    scene_u8 = np.require(tiler._indata, requirements=["C", "W"])  # PIL's arrays are read-only
    out = fn(torch.from_numpy(scene_u8), torch.from_numpy(tiler.subtiles_to_use)).cpu().numpy()
    th, tw = tiler._indata.shape[:2]
    if out.shape == (th, tw):  # a custom predictor returned an unpacked map
        tiler._outdata = out
    else:
        tiler._outdata = unpack2(out, tw)
    return tiler.prediction


def predict_scenes(
    model: torch.nn.Module,
    scenes: Sequence[np.ndarray],
    *,
    tile_shape: Tuple[int, int] = (2048, 2048),
    subtile: int = 512,
    batch_size: int = 128,
    scenes_per_dispatch: Optional[int] = None,
    predictor: Optional[Callable] = None,
    mean: Sequence[float] = DATASET_CONFIG.mean,
    std: Sequence[float] = DATASET_CONFIG.std,
    tta: int = 0,
    device: Device = None,
) -> list:
    """Batched scene inference: N scenes → N (H, W) class maps.

    Packs ``scenes_per_dispatch`` scenes into one predictor call (default:
    enough to fill one ``batch_size`` chunk; the tail group is padded with
    zero scenes, so every call has one shape) and keeps at most two calls
    in flight. On CUDA each group is staged in one of two pinned host
    buffers and uploaded with ``non_blocking=True`` on a side stream; its
    packed result stays on the device until the next group has been
    launched, and is then copied back on the side stream (which waits for
    that group's forward only) and unpacked on the host while the device
    runs the next group. Runs on CUDA unless ``device="cpu"``; raises
    without CUDA."""
    device = resolve_device(device)
    per_scene = (tile_shape[0] // subtile) * (tile_shape[1] // subtile)
    if scenes_per_dispatch is None:
        scenes_per_dispatch = max(1, batch_size // per_scene)
    fn = predictor or make_scene_predictor(
        model, subtile=subtile, batch_size=batch_size, mean=mean, std=std,
        packed=True, tta=tta, device=device,
    )
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    staging = [None, None]  # pinned host buffers, one per dispatch in flight
    uploaded = [None, None]  # events: each buffer's upload has finished

    scenes = list(scenes)
    results: list = [None] * len(scenes)
    g = scenes_per_dispatch
    pending: list = []

    def upload(k: int, tilers: list, vstack: np.ndarray):
        if not cuda:
            stack = np.zeros((g,) + tilers[0]._indata.shape, tilers[0]._indata.dtype)
            for j, t in enumerate(tilers):
                stack[j] = t._indata
            return torch.from_numpy(stack), torch.from_numpy(vstack)
        slot = k % 2
        first = tilers[0]._indata
        shape = (g,) + first.shape
        dtype = torch.from_numpy(np.empty(0, first.dtype)).dtype
        if staging[slot] is None or (tuple(staging[slot].shape), staging[slot].dtype) != (
            shape, dtype
        ):
            staging[slot] = torch.empty(shape, dtype=dtype, pin_memory=True)
        else:
            uploaded[slot].synchronize()  # its previous upload has been read
        buf = staging[slot].numpy()
        for j, t in enumerate(tilers):
            buf[j] = t._indata
        buf[len(tilers):] = 0  # the tail group's zero scenes
        with torch.cuda.stream(side):
            scene = staging[slot].to(device, non_blocking=True)
            valid = torch.from_numpy(vstack).to(device, non_blocking=True)
            uploaded[slot] = torch.cuda.Event()
            uploaded[slot].record(side)
        compute = torch.cuda.current_stream(device)
        compute.wait_event(uploaded[slot])
        scene.record_stream(compute)
        valid.record_stream(compute)
        return scene, valid

    def drain(entry) -> None:
        idx, tilers, out, done = entry
        if cuda:
            pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            with torch.cuda.stream(side):
                side.wait_event(done)
                pinned.copy_(out, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            copied.synchronize()
            out = pinned
        packed = out.numpy()  # (g, TH, TW // 4)
        for j, i in enumerate(idx):
            t = tilers[j]
            t._outdata = unpack2(packed[j], t._indata.shape[1])
            results[i] = t.prediction

    for k, start in enumerate(range(0, len(scenes), g)):
        idx = list(range(start, min(start + g, len(scenes))))
        tilers = []
        for i in idx:
            t = Tiler(tile_shape=tile_shape, subtile_shape=(subtile, subtile))
            t.load_array(scenes[i])
            tilers.append(t)
        vstack = np.zeros((g,) + tilers[0].subtiles_to_use.shape, bool)
        for j, t in enumerate(tilers):
            vstack[j] = t.subtiles_to_use
        out = fn(*upload(k, tilers, vstack))
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
        pending.append((idx, tilers, out, done))
        if len(pending) > 1:  # two in flight, the one just launched included
            drain(pending.pop(0))

    for entry in pending:
        drain(entry)
    return results
