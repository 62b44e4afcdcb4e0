"""The launch grid of the tiled kernels (``csrc/sc_step.cu``,
``csrc/hcz_step.cu``, ``csrc/hcz3d_step.cu``): one block a tile (in 3D a
tile and a chunk of z-planes), tiles over the whole lattice."""
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


def launch_geometry_3d(nz: int, ny: int, nx: int, tile,
                       zc: int) -> tuple[int, int, int]:
    """The grid for an ``nz × ny × nx`` box, ``(chunks, tiles_y, tiles_x)``:
    tiles of ``tile`` (rows, columns) and chunks of ``zc`` z-planes; raises
    ``ValueError`` where the kernel's 32-bit indices (19 populations a
    cell) or the grid's 65,535 tile rows or chunks do not reach."""
    if nz < 1 or ny < 1 or nx < 1:
        raise ValueError(f"empty box {nz} x {ny} x {nx}")
    if 19 * nz * ny * nx >= 2 ** 31:
        raise ValueError(f"box {nz} x {ny} x {nx} has 19·nz·ny·nx = "
                         f"{19 * nz * ny * nx} population slots; the kernel "
                         "indexes < 2^31")
    grid = (-(-nz // zc), -(-ny // tile[0]), -(-nx // tile[1]))
    if grid[0] > 65535 or grid[1] > 65535:
        raise ValueError(f"box {nz} x {ny} x {nx} needs {grid[0]} chunks and "
                         f"{grid[1]} tile rows (each at most 65535)")
    return grid
