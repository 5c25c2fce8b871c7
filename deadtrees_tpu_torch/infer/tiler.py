"""Tiler: whole orthophoto scene ↔ padded subtile batches.

Counterpart of ``deadtrees_tpu.infer.tiler`` (host numpy, as there): zero-
pad the scene up to ``tile_shape``, mark the subtiles that contain real
data, emit them as a batch, reassemble predictions, crop back, write a
georeferenced LZW GeoTIFF. File IO is a thin edge (``geotiff.py``), the
tiling math is ``blocks.py``, and the scene predictor (``sliding.py``)
takes the padded scene to the device.

Defaults: tile 2048², subtile 512²; ``inspect_tile`` keeps its own
defaults of 8192/512, as the JAX package's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from deadtrees_tpu_torch.infer.blocks import make_blocks_nhwc, unmake_blocks_nhwc
from deadtrees_tpu_torch.infer.geotiff import GeoImage, read_geotiff, write_geotiff


@dataclass
class TileInfo:
    size: Tuple[int, int]
    subtiles: Tuple[int, int]


def divisible_without_remainder(a, b) -> bool:
    if b == 0:
        return False
    return a % b == 0


def inspect_tile(
    infile: Union[str, Path, np.ndarray],
    tile_shape: Tuple[int, int] = (8192, 8192),
    subtile_shape: Tuple[int, int] = (512, 512),
) -> TileInfo:
    """Scene dims + ceil subtile counts; accepts a path or an (H, W[, C])
    array."""
    if isinstance(infile, np.ndarray):
        shape = tuple(infile.shape[:2])
    else:
        shape = tuple(read_geotiff(infile).data.shape[:2])

    if not divisible_without_remainder(tile_shape[0], subtile_shape[0]):
        raise ValueError(f"Shapes unaligned (v): {tile_shape[0], subtile_shape[0]}")
    if not divisible_without_remainder(tile_shape[1], subtile_shape[1]):
        raise ValueError(f"Shapes unaligned (h): {tile_shape[1], subtile_shape[1]}")

    subtiles = (
        math.ceil(shape[0] / subtile_shape[0]),
        math.ceil(shape[1] / subtile_shape[1]),
    )
    return TileInfo(size=shape, subtiles=subtiles)


class Tiler:
    """Scene → padded (N, d, d, C) batches → stitched prediction → file."""

    def __init__(
        self,
        infile: Optional[Union[str, Path]] = None,
        tile_shape: Tuple[int, int] = (2048, 2048),
        subtile_shape: Tuple[int, int] = (512, 512),
    ):
        if subtile_shape[0] != subtile_shape[1]:
            raise ValueError("Subtile required to have matching x/y dims")
        self._infile = infile
        self._tile_shape = tuple(tile_shape)
        self._subtile_shape = tuple(subtile_shape)

        self._geo: Optional[GeoImage] = None
        self._indata: Optional[np.ndarray] = None  # (H, W, C) padded
        self._outdata: Optional[np.ndarray] = None  # (H, W) padded
        self._subtiles_to_use: Optional[np.ndarray] = None
        self._tile_info: Optional[TileInfo] = None

    # -- loading -----------------------------------------------------------
    def load_file(
        self,
        infile: Union[str, Path],
        tile_shape: Optional[Tuple[int, int]] = None,
        subtile_shape: Optional[Tuple[int, int]] = None,
    ) -> None:
        geo = read_geotiff(infile)
        self._infile = infile
        self.load_array(geo.data, geo, tile_shape, subtile_shape)

    def load_array(
        self,
        data: np.ndarray,
        geo: Optional[GeoImage] = None,
        tile_shape: Optional[Tuple[int, int]] = None,
        subtile_shape: Optional[Tuple[int, int]] = None,
    ) -> None:
        """Array-first entry: (H, W, C) scene data."""
        self._tile_shape = tuple(tile_shape or self._tile_shape)
        if subtile_shape and subtile_shape[0] != subtile_shape[1]:
            raise ValueError("Subtile required to have matching x/y dims")
        self._subtile_shape = tuple(subtile_shape or self._subtile_shape)

        if data.ndim == 2:
            data = data[..., None]
        self._tile_info = inspect_tile(data, self._tile_shape, self._subtile_shape)
        self._geo = geo if geo is not None else GeoImage(data)

        h, w, c = data.shape
        if h > self._tile_shape[0] or w > self._tile_shape[1]:
            raise ValueError(
                f"scene {h}x{w} exceeds tile_shape {self._tile_shape}; "
                "construct the Tiler with a tile_shape >= the scene "
                "(the inference CLI auto-sizes from the scene headers)"
            )
        if (h, w) != self._tile_shape:
            self._indata = np.zeros((*self._tile_shape, c), dtype=data.dtype)
            self._indata[:h, :w] = data
        else:
            self._indata = data

        self._outdata = np.zeros(self._tile_shape, dtype=np.uint8)

        grid = (
            self._tile_shape[0] // self._subtile_shape[0],
            self._tile_shape[1] // self._subtile_shape[1],
        )
        mask = np.zeros(grid, dtype=bool)
        mask[: self._tile_info.subtiles[0], : self._tile_info.subtiles[1]] = True
        self._subtiles_to_use = mask.ravel()

    # -- batches -----------------------------------------------------------
    @property
    def tile_info(self) -> Optional[TileInfo]:
        return self._tile_info

    @property
    def subtiles_to_use(self) -> np.ndarray:
        return self._subtiles_to_use

    def get_batches(self) -> np.ndarray:
        """Valid subtiles as (N, d, d, C)."""
        subtiles = np.asarray(
            make_blocks_nhwc(self._indata, self._subtile_shape[0])
        )
        return subtiles[self._subtiles_to_use]

    def get_all_batches(self) -> np.ndarray:
        """ALL padded subtiles (for the on-device predictor, which masks)."""
        return np.asarray(make_blocks_nhwc(self._indata, self._subtile_shape[0]))

    def put_batches(self, batches: np.ndarray) -> None:
        """Stitch valid-subtile predictions (N, d, d) back."""
        d = self._subtile_shape[0]
        full = np.zeros(
            (self._subtiles_to_use.size, d, d), dtype=np.asarray(batches).dtype
        )
        full[self._subtiles_to_use] = np.asarray(batches)
        self._outdata = np.asarray(
            unmake_blocks_nhwc(full, self._tile_shape[0], self._tile_shape[1])
        ).astype(np.uint8)

    def put_all_batches(self, batches: np.ndarray) -> None:
        """Stitch a full (padded) prediction batch."""
        self._outdata = np.asarray(
            unmake_blocks_nhwc(
                np.asarray(batches), self._tile_shape[0], self._tile_shape[1]
            )
        ).astype(np.uint8)

    # -- output ------------------------------------------------------------
    @property
    def prediction(self) -> np.ndarray:
        """Stitched prediction cropped to the original scene size."""
        h, w = self._tile_info.size
        return self._outdata[:h, :w]

    def write_file(self, outfile: Union[str, Path]) -> None:
        write_geotiff(outfile, self.prediction, self._geo.geo if self._geo else None)
