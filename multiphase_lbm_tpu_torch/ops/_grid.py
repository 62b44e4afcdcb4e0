"""The launch grid of the tiled kernels (``csrc/sc_step.cu``,
``csrc/hcz_step.cu``): one block a tile, tiles over the whole lattice."""
from __future__ import annotations


def launch_geometry(ny: int, nx: int, tile) -> tuple[int, int]:
    """The grid for an ``ny × nx`` lattice, ``(tiles_y, tiles_x)`` tiles of
    ``tile`` (rows, columns); raises ``ValueError`` where the kernels'
    32-bit indices or the grid's 65,535 tile rows do not reach."""
    if ny < 1 or nx < 1:
        raise ValueError(f"empty lattice {ny} x {nx}")
    if 9 * ny * nx >= 2 ** 31:
        raise ValueError(f"lattice {ny} x {nx} has 9·ny·nx = {9 * ny * nx} "
                         "population slots; the kernel indexes < 2^31")
    tiles = (-(-ny // tile[0]), -(-nx // tile[1]))
    if tiles[0] > 65535:
        raise ValueError(f"{ny} rows need {tiles[0]} tile rows (> 65535)")
    return tiles
