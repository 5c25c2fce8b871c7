"""Batch scene inference CLI: orthophoto tiles → predicted mask GeoTIFFs.

    python -m deadtrees_tpu_torch.infer.scene SCENE.tif CKPT [CKPT ...]
    python -m deadtrees_tpu_torch.infer.scene DIR CKPT --all --mosaic out.tif

Counterpart of the JAX package's ``scripts/inference.py``:

- single scene or ``--all`` directory mode (ortho*.tif);
- empty-scene skip (all values of the first band in {0, 1});
- one checkpoint: the scene predictor (``sliding.py``) over groups of
  scenes, the tail group padded with zero scenes; N checkpoints: the
  odd-N ``EnsembleInference`` majority vote over each scene's subtiles;
- GeoTIFF output with the input's georeferencing, an optional PNG
  preview, and an optional mosaic of all outputs.

Runs on CUDA unless ``--device cpu`` is given; raises without CUDA.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m deadtrees_tpu_torch.infer.scene")
    parser.add_argument("infile", type=Path, help="scene GeoTIFF (or directory with --all)")
    parser.add_argument("checkpoints", type=Path, nargs="+")
    parser.add_argument("--outpath", type=Path, default=Path("."))
    parser.add_argument("--all", action="store_true", help="process ortho*.tif in dir")
    parser.add_argument("--bs", type=int, default=128)
    parser.add_argument(
        "--tile-shape", type=int, default=None,
        help="padded scene size per predictor call (default: auto — the "
        "largest scene dimension on disk rounded up to a subtile multiple, "
        "read from the TIFF headers)",
    )
    parser.add_argument(
        "--subtile", type=int, default=512, help="model input size per subtile",
    )
    parser.add_argument(
        "--scenes-per-dispatch", type=int, default=None,
        help="scenes batched per predictor call (default: fill one --bs "
        "chunk; a 2048² scene has 16 subtiles of 512², so bs=128 packs 8 "
        "scenes per call)",
    )
    parser.add_argument(
        "--tta", type=int, default=0, choices=(0, 4, 8),
        help="test-time augmentation views: 0 off, 4 rotations, 8 full "
        "dihedral; about views× the device compute",
    )
    parser.add_argument("--preview", action="store_true", help="also write PNG preview")
    parser.add_argument(
        "--mosaic", type=Path, default=None,
        help="after all scenes, merge the predicted tiles into this single "
        "georeferenced mosaic",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device the model runs on (cuda, cuda:N or cpu); raises when "
        "CUDA is asked for and missing",
    )
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)

    from deadtrees_tpu_torch.infer import (
        EnsembleInference,
        Tiler,
        TorchInference,
        make_scene_predictor,
        unpack2,
    )
    from deadtrees_tpu_torch.infer.geotiff import geotiff_size, read_geotiff

    if len(args.checkpoints) == 1:
        engine = TorchInference(args.checkpoints[0], device=args.device)
    else:
        engine = EnsembleInference(args.checkpoints, device=args.device)

    scenes = sorted(args.infile.glob("ortho*.tif")) if args.all else [args.infile]
    args.outpath.mkdir(parents=True, exist_ok=True)

    if args.tile_shape is None:
        longest = max((max(geotiff_size(p)) for p in scenes), default=2048)
        args.tile_shape = -(-longest // args.subtile) * args.subtile
        print(f"tile shape auto-sized to {args.tile_shape} "
              f"(longest scene dim {longest}, subtile {args.subtile})")

    def write_out(tiler, scene_path):
        outfile = args.outpath / scene_path.name
        tiler.write_file(outfile)
        print(f"wrote {outfile}")
        if args.preview:
            from PIL import Image

            Image.fromarray(
                (tiler.prediction * 127).clip(0, 255).astype(np.uint8)
            ).save(outfile.with_suffix(".png"))

    # scenes per predictor call: fill at least one full chunk
    per_scene = (args.tile_shape // args.subtile) ** 2
    spd = args.scenes_per_dispatch or max(1, args.bs // per_scene)

    predictor = None
    group = []  # [(scene_path, tiler)] awaiting one batched call

    def flush_group():
        nonlocal predictor
        if not group:
            return
        if predictor is None:
            predictor = make_scene_predictor(
                engine.model, subtile=args.subtile, batch_size=args.bs,
                packed=True, tta=args.tta, device=engine.device,
            )
        stack = np.stack([t._indata for _, t in group])
        vstack = np.stack([t.subtiles_to_use for _, t in group])
        if len(group) < spd:  # pad the tail: the same shape as every call
            pad = spd - len(group)
            stack = np.concatenate([stack, np.zeros((pad,) + stack.shape[1:], stack.dtype)])
            vstack = np.concatenate([vstack, np.zeros((pad,) + vstack.shape[1:], vstack.dtype)])
        out = predictor(torch.from_numpy(stack), torch.from_numpy(vstack)).cpu().numpy()
        for j, (scene_path, tiler) in enumerate(group):
            tiler._outdata = unpack2(out[j], tiler._indata.shape[1])
            write_out(tiler, scene_path)
        group.clear()

    for scene_path in scenes:
        geo = read_geotiff(scene_path)
        data = geo.data
        if np.isin(data[..., 0], [0, 1]).all():
            print(f"skip empty scene: {scene_path.name}")
            continue
        if data.shape[-1] > engine.in_channels:
            data = data[..., : engine.in_channels]

        tiler = Tiler(
            tile_shape=(args.tile_shape, args.tile_shape),
            subtile_shape=(args.subtile, args.subtile),
        )
        tiler.load_array(data, geo)

        if isinstance(engine, TorchInference):
            group.append((scene_path, tiler))
            if len(group) >= spd:
                flush_group()
        else:
            batches = tiler.get_batches()
            preds = [
                engine.run(chunk)
                for chunk in np.array_split(batches, max(1, len(batches) // args.bs))
            ]
            tiler.put_batches(np.concatenate(preds))
            write_out(tiler, scene_path)

    flush_group()

    if args.mosaic is not None:
        from deadtrees_tpu_torch.geo.mosaic import merge_tiles

        written = [args.outpath / p.name for p in scenes if (args.outpath / p.name).exists()]
        if written:
            summary = merge_tiles(written, args.mosaic)
            print(f"wrote mosaic {args.mosaic}: {summary['tiles']} tiles, "
                  f"{summary['height']}x{summary['width']} px")
        else:
            print("no predicted tiles written; mosaic skipped")


if __name__ == "__main__":
    main()
