"""NanoVDB (.nvdb) file codec — written from the published on-disk layout.

The reference's volume viewer loads real NanoVDB fog-volume grids
(`optixVolumeViewer.cpp:641-678`) through the vendored NanoVDB headers
(ABI version 29: `optixVolumeViewer/nanovdb/NanoVDB.h:100`). This module
reads (and writes) that format directly with numpy — no OpenVDB
dependency — and densifies the sparse tree into the engine's
`accel.volume.DensityGrid` dense array (device memory is plentiful and
dense trilinear sampling vectorizes; a sparse grid is ROADMAP R6).

File layout (`nanovdb/util/IO.h:100-165`): one or more segments, each
  Header   {magic u64 "NanoVDB0", version u32, gridCount u16, codec u16}
  per grid MetaData (160 B, memcpy of the C struct) + gridName bytes
  per grid the grid blob (raw for codec NONE, zlib chunks for ZIP)

Grid blob layout (`nanovdb/NanoVDB.h:91`, all structs 32-byte aligned):
  [GridData 672][TreeData 64][RootData 64][Tile 32 x N]
  [upper InternalData(5) 139328 x N][lower InternalData(4) 17472 x N]
  [LeafData(3) 2144 x N]
Root tiles address the upper array immediately after them
(`NanoVDB.h:2267`); internal nodes address their child level through
per-level arrays, childID being a global index within the level — which
is also how `TreeData.mBytes[level]` exposes the arrays, so
densification never chases pointers: every level is one structured-numpy
parse.
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

MAGIC = 0x304244566F6E614E  # "NanoVDB0", little endian
ABI = 29                    # the ABI the reference's headers implement

CODEC_NONE, CODEC_ZIP, CODEC_BLOSC = 0, 1, 2

GRID_TYPE_FLOAT = 1
GRID_CLASS_UNKNOWN, GRID_CLASS_LEVEL_SET, GRID_CLASS_FOG = 0, 1, 2
GRID_CLASS_NAMES = {0: "unknown", 1: "levelset", 2: "fogvolume",
                    3: "staggered", 4: "pointindex", 5: "pointdata"}

_MAX_CHUNK = 1 << 30        # io::MAX_SIZE — ZIP splits the blob at 1 GB

# ---- struct sizes (float value type), asserted against the header's
#      documented totals (`NanoVDB.h:67-75`) ----
GRIDDATA_SIZE = 672
TREEDATA_SIZE = 64
ROOTDATA_SIZE = 64
ROOT_TILE_SIZE = 32
UPPER_SIZE = 8256 + 4 * (1 << 15)     # 139328: masks 2x4096B + table 32^3
LOWER_SIZE = 1088 + 4 * (1 << 12)     # 17472:  masks 2x512B  + table 16^3
LEAF_SIZE = 96 + 4 * 512              # 2144

_LEAF_DT = np.dtype([
    ("bbox_min", "<i4", (3,)), ("bbox_dif", "u1", (3,)), ("flags", "u1"),
    ("value_mask", "<u8", (8,)),
    ("minimum", "<f4"), ("maximum", "<f4"),
    ("average", "<f4"), ("stddev", "<f4"),
    ("values", "<f4", (512,)),
])
_TILE_DT = np.dtype([("key", "<u8"), ("child_id", "<i4"),
                     ("state", "<u4"), ("value", "<f4"),
                     ("_pad", "V12")])
assert _LEAF_DT.itemsize == LEAF_SIZE and _TILE_DT.itemsize == ROOT_TILE_SIZE


def _internal_dt(log2dim: int) -> np.dtype:
    words = (1 << (3 * log2dim)) // 64
    pad = 16 if log2dim == 4 else 16   # stats end 16 bytes short of 32-align
    return np.dtype([
        ("bbox", "<i4", (6,)), ("offset", "<i4"), ("flags", "<u4"),
        ("value_mask", "<u8", (words,)), ("child_mask", "<u8", (words,)),
        ("minimum", "<f4"), ("maximum", "<f4"),
        ("average", "<f4"), ("stddev", "<f4"),
        ("_pad", f"V{pad}"),
        ("table", "<u4", (1 << (3 * log2dim),)),
    ])


_UPPER_DT = _internal_dt(5)
_LOWER_DT = _internal_dt(4)
assert _UPPER_DT.itemsize == UPPER_SIZE and _LOWER_DT.itemsize == LOWER_SIZE


@dataclass
class GridMeta:
    """One grid's 160-byte file metadata (`IO.h:131-144`)."""
    name: str
    grid_type: int
    grid_class: int
    grid_size: int          # bytes in memory
    file_size: int          # bytes on disk (== grid_size for codec NONE)
    voxel_count: int
    world_bbox: np.ndarray  # [2, 3] f64
    index_bbox: np.ndarray  # [2, 3] i32 (max is inclusive)
    voxel_size: np.ndarray  # [3] f64
    codec: int
    blob_offset: int        # file offset of this grid's blob


@dataclass
class NvdbGrid:
    """A densified NanoVDB grid: values plus its index->world placement."""
    values: np.ndarray      # [D, H, W] f32, (z, y, x) index order
    ijk_min: np.ndarray     # [3] i32 index-space origin (x, y, z)
    voxel_size: np.ndarray  # [3] f64 world units per voxel
    translation: np.ndarray  # [3] f64 world position of index (0,0,0)
    name: str
    grid_class: int
    background: float

    @property
    def world_lo(self) -> np.ndarray:
        return self.translation + self.ijk_min * self.voxel_size

    @property
    def world_hi(self) -> np.ndarray:
        # +1: voxel (i,j,k) covers [ijk, ijk+1) in index space — the
        # reference extends indexBBox.max by one unit the same way
        # (`optixVolumeViewer.cpp:713-716`)
        dims_xyz = np.asarray(self.values.shape[::-1], np.float64)
        return self.translation + (self.ijk_min + dims_xyz) * self.voxel_size


def _parse_meta(buf: bytes, off: int) -> tuple[GridMeta, int]:
    (grid_size, file_size, _name_key, voxel_count, grid_type, grid_class,
     ) = struct.unpack_from("<4QII", buf, off)
    world_bbox = np.frombuffer(buf, "<f8", 6, off + 40).reshape(2, 3)
    index_bbox = np.frombuffer(buf, "<i4", 6, off + 88).reshape(2, 3)
    voxel_size = np.frombuffer(buf, "<f8", 3, off + 112)
    name_size, = struct.unpack_from("<I", buf, off + 136)
    codec, = struct.unpack_from("<H", buf, off + 156)
    off += 160
    name = buf[off:off + name_size].split(b"\0")[0].decode("utf-8",
                                                           "replace")
    off += name_size
    return GridMeta(name=name, grid_type=grid_type, grid_class=grid_class,
                    grid_size=grid_size, file_size=file_size,
                    voxel_count=voxel_count, world_bbox=world_bbox.copy(),
                    index_bbox=index_bbox.copy(),
                    voxel_size=voxel_size.copy(), codec=codec,
                    blob_offset=-1), off


def read_grid_metadata(path: str) -> list[GridMeta]:
    """All grids' metadata across all segments (readGridMetaData parity,
    `optixVolumeViewer.cpp:645`)."""
    with open(path, "rb") as f:
        buf = f.read()
    metas: list[GridMeta] = []
    off = 0
    while off + 16 <= len(buf):
        magic, _version, grid_count, codec = struct.unpack_from(
            "<QIHH", buf, off)
        if magic != MAGIC:
            raise ValueError(
                f"{path}: bad NanoVDB magic {magic:#x} at offset {off}")
        off += 16
        seg = []
        for _ in range(grid_count):
            meta, off = _parse_meta(buf, off)
            meta.codec = codec
            seg.append(meta)
        for meta in seg:
            meta.blob_offset = off
            # on-disk blob length: raw for NONE; ZIP/BLOSC chunk streams
            # carry u64 chunk headers (`IO.h:240-280`)
            if codec == CODEC_NONE:
                off += meta.grid_size
            else:
                residual = meta.grid_size
                while residual > 0:
                    nbytes, = struct.unpack_from("<Q", buf, off)
                    off += 8 + nbytes
                    residual -= min(residual, _MAX_CHUNK)
        metas.extend(seg)
    return metas


def _read_blob(buf: bytes, meta: GridMeta) -> bytes:
    off = meta.blob_offset
    if meta.codec == CODEC_NONE:
        return buf[off:off + meta.grid_size]
    if meta.codec == CODEC_ZIP:
        out = []
        residual = meta.grid_size
        while residual > 0:
            nbytes, = struct.unpack_from("<Q", buf, off)
            off += 8
            out.append(zlib.decompress(buf[off:off + nbytes]))
            off += nbytes
            residual -= len(out[-1])
        return b"".join(out)
    raise NotImplementedError(
        f"NanoVDB codec {meta.codec} (BLOSC) not supported")


def _bits(words: np.ndarray, n: int) -> np.ndarray:
    """[..., n] bool from little-endian u64 mask words."""
    b = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return b[..., :n].astype(bool)


def _key_to_coord(key: np.ndarray) -> np.ndarray:
    """Root-tile key -> upper-node origin: 21-bit fields, z in the LOW
    bits (`NanoVDB.h:2199-2214`), <<12 = upper-node span 4096. The fields
    are uint32 coordinates shifted right, so negative origins wrap — undo
    via the uint32 -> int32 reinterpretation."""
    m = np.uint64((1 << 21) - 1)

    def field(f):
        v = ((f & m) << np.uint64(12)) & np.uint64(0xFFFFFFFF)
        return np.atleast_1d(v).astype(np.uint32).view(np.int32)

    z = field(key)
    y = field(key >> np.uint64(21))
    x = field(key >> np.uint64(42))
    return np.stack([x, y, z], -1)


def _local_coords(log2dim: int) -> np.ndarray:
    """OffsetToLocalCoord for every table slot: n -> (x, y, z) with x in
    the HIGH bits (`NanoVDB.h:2664-2669`)."""
    n = np.arange(1 << (3 * log2dim))
    lo = (1 << log2dim) - 1
    return np.stack([(n >> (2 * log2dim)) & lo, (n >> log2dim) & lo,
                     n & lo], -1).astype(np.int32)


def read_nvdb(path: str, grid_name: str | None = None) -> NvdbGrid:
    """Read one float grid from a .nvdb file and densify it.

    The sparse tree collapses level by level: leaves scatter 8^3 blocks,
    internal value tiles broadcast constant 8^3/128^3/4096^3 regions, all
    clipped to the root's active bbox. Inactive voxels read as the
    background value.
    """
    with open(path, "rb") as f:
        buf = f.read()
    metas = read_grid_metadata(path)
    if not metas:
        raise ValueError(f"{path}: no grids")
    if grid_name is None:
        meta = metas[0]
    else:
        named = [m for m in metas if m.name == grid_name]
        if not named:
            raise ValueError(f"{path}: no grid named {grid_name!r}; "
                             f"grids: {[m.name for m in metas]}")
        meta = named[0]
    if meta.grid_type != GRID_TYPE_FLOAT:
        raise NotImplementedError(
            f"grid {meta.name!r}: only float grids supported "
            f"(gridType={meta.grid_type})")
    blob = _read_blob(buf, meta)

    # ---- GridData (`NanoVDB.h:1702-1806`) ----
    magic, = struct.unpack_from("<Q", blob, 0)
    if magic != MAGIC:
        raise ValueError(f"grid blob magic mismatch ({magic:#x})")
    version, = struct.unpack_from("<I", blob, 16)
    major = version >> 21
    if major != ABI:
        raise NotImplementedError(
            f"NanoVDB ABI {major} not supported (reader implements "
            f"ABI {ABI}, the reference's vendored version)")
    # Map at 288: affine index->world. The dense grid is an AABB, so a
    # rotation/shear cannot be represented — reject loudly.
    mat_d = np.frombuffer(blob, "<f8", 9, 288 + 88).reshape(3, 3)
    vec_d = np.frombuffer(blob, "<f8", 3, 288 + 88 + 144)
    off_diag = mat_d - np.diag(np.diag(mat_d))
    if np.abs(off_diag).max() > 1e-9 * max(1.0, np.abs(mat_d).max()):
        raise NotImplementedError(
            f"grid {meta.name!r} has a rotated/sheared index->world map; "
            "only axis-aligned scale+translation is supported")
    grid_class, = struct.unpack_from("<I", blob, 624)

    # ---- TreeData at 672 (`NanoVDB.h:1983-1989`) ----
    t = GRIDDATA_SIZE
    mbytes = np.frombuffer(blob, "<u8", 4, t)
    mcount = np.frombuffer(blob, "<u4", 4, t + 32)
    n_leaf, n_lower, n_upper, _ = (int(c) for c in mcount)

    # ---- RootData (`NanoVDB.h:2193-2275`) ----
    r = t + int(mbytes[3])
    root_bbox = np.frombuffer(blob, "<i4", 6, r).reshape(2, 3)
    tile_count, = struct.unpack_from("<I", blob, r + 32)
    background, = struct.unpack_from("<f", blob, r + 36)
    tiles = np.frombuffer(blob, _TILE_DT, tile_count, r + ROOTDATA_SIZE)

    ijk_min = root_bbox[0].copy()
    dims_xyz = root_bbox[1] - root_bbox[0] + 1     # max is inclusive
    if (dims_xyz <= 0).any():
        raise ValueError(f"grid {meta.name!r}: empty index bbox")
    # 8-aligned canvas so leaf blocks scatter as whole blocks
    base = ijk_min & ~7
    ext = -(-(ijk_min + dims_xyz - base) // 8) * 8  # xyz, multiples of 8
    nb = ext // 8                                   # blocks per axis, xyz
    canvas = np.full((nb[2], nb[1], nb[0], 8, 8, 8), background,
                     np.float32)                    # [bz,by,bx][z,y,x]

    def fill(org_xyz: np.ndarray, span: int, value: float) -> None:
        """Broadcast a constant tile, clipped to the canvas."""
        lo = np.maximum(org_xyz - base, 0)
        hi = np.minimum(org_xyz + span - base, ext)
        if (hi <= lo).any():
            return
        flat = canvas.transpose(0, 3, 1, 4, 2, 5).reshape(
            ext[2], ext[1], ext[0])
        flat[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]] = value
        canvas[...] = flat.reshape(nb[2], 8, nb[1], 8, nb[0], 8
                                   ).transpose(0, 2, 4, 1, 3, 5)

    upper = (np.frombuffer(blob, _UPPER_DT, n_upper, t + int(mbytes[2]))
             if n_upper else np.empty(0, _UPPER_DT))
    lower = (np.frombuffer(blob, _LOWER_DT, n_lower, t + int(mbytes[1]))
             if n_lower else np.empty(0, _LOWER_DT))

    # ---- walk root -> upper -> lower for node origins + value tiles ----
    upper_org = np.zeros((n_upper, 3), np.int32)
    lower_org = np.zeros((n_lower, 3), np.int32)
    tile_org = _key_to_coord(tiles["key"])
    for i in range(tile_count):
        cid = int(tiles["child_id"][i])
        if cid < 0:
            if tiles["state"][i] and tiles["value"][i] != background:
                fill(tile_org[i], 4096, float(tiles["value"][i]))
        else:
            upper_org[cid] = tile_org[i]
    loc5 = _local_coords(5)
    for i in range(n_upper):
        node = upper[i]
        vmask = _bits(node["value_mask"], 1 << 15)
        cmask = _bits(node["child_mask"], 1 << 15)
        vals = node["table"].view(np.float32)
        for n in np.nonzero(vmask & ~cmask)[0]:
            if vals[n] != background:
                fill(upper_org[i] + loc5[n] * 128, 128, float(vals[n]))
        kids = np.nonzero(cmask)[0]
        lower_org[node["table"][kids]] = upper_org[i] + loc5[kids] * 128
    loc4 = _local_coords(4)
    for i in range(n_lower):
        node = lower[i]
        vmask = _bits(node["value_mask"], 1 << 12)
        cmask = _bits(node["child_mask"], 1 << 12)
        vals = node["table"].view(np.float32)
        for n in np.nonzero(vmask & ~cmask)[0]:
            if vals[n] != background:
                fill(lower_org[i] + loc4[n] * 8, 8, float(vals[n]))

    # ---- leaves: one vectorized scatter (origin = bboxMin & ~7,
    #      LeafNode::origin(); value order x-major, `NanoVDB.h:2657`) ----
    if n_leaf:
        leaves = np.frombuffer(blob, _LEAF_DT, n_leaf, t + int(mbytes[0]))
        org = (leaves["bbox_min"] & ~7) - base          # [N, 3] xyz
        blk = org >> 3
        mask = _bits(leaves["value_mask"], 512).reshape(-1, 8, 8, 8)
        vals = np.where(mask, leaves["values"].reshape(-1, 8, 8, 8),
                        background)
        # [x][y][z] -> [z][y][x]
        vals = vals.transpose(0, 3, 2, 1)
        ok = ((blk >= 0) & (blk < nb)).all(axis=1)
        canvas[blk[ok, 2], blk[ok, 1], blk[ok, 0]] = vals[ok]

    dense = canvas.transpose(0, 3, 1, 4, 2, 5).reshape(ext[2], ext[1],
                                                       ext[0])
    o = ijk_min - base
    dense = dense[o[2]:o[2] + dims_xyz[2], o[1]:o[1] + dims_xyz[1],
                  o[0]:o[0] + dims_xyz[0]]
    return NvdbGrid(values=np.ascontiguousarray(dense), ijk_min=ijk_min,
                    voxel_size=np.diag(mat_d).copy(),
                    translation=vec_d.copy(), name=meta.name,
                    grid_class=grid_class, background=float(background))


def load_density_grid(path: str, grid_name: str | None = None,
                      max_voxels: int = 192 ** 3):
    """Read a .nvdb fog volume into the engine's `DensityGrid`, mean-pool
    downsampling when the dense grid would pass `max_voxels`."""
    import jax.numpy as jnp
    from ..accel.volume import DensityGrid

    g = read_nvdb(path, grid_name)
    if g.grid_class == GRID_CLASS_LEVEL_SET:
        # SDF: inside (negative) becomes unit density
        vals = (g.values < 0.0).astype(np.float32)
    else:
        vals = np.maximum(g.values, 0.0)
    lo = g.world_lo.astype(np.float32)
    hi = g.world_hi.astype(np.float32)
    if vals.size > max_voxels:
        f = int(np.ceil((vals.size / max_voxels) ** (1 / 3)))
        pad = [(0, (-s) % f) for s in vals.shape]
        vals = np.pad(vals, pad)
        d, h, w = (s // f for s in vals.shape)
        vals = vals.reshape(d, f, h, f, w, f).mean(axis=(1, 3, 5))
        # padding extended the sampled region; stretch hi to match
        hi = lo + (hi - lo) * np.array(
            [p[1] + s for (s, p) in zip(g.values.shape, pad)][::-1],
            np.float32) / np.asarray(g.values.shape[::-1], np.float32)
    return DensityGrid(density=jnp.asarray(vals, jnp.float32),
                       lo=jnp.asarray(lo), hi=jnp.asarray(hi))


# --------------------------------------------------------------------------
# Writer — builds a real sparse NanoVDB tree from a dense array, for
# round-trip tests and for generating assets the reference viewer itself
# could load.
# --------------------------------------------------------------------------

def write_nvdb(path: str, values: np.ndarray, ijk_min=(0, 0, 0),
               voxel_size=1.0, translation=(0.0, 0.0, 0.0),
               name: str = "density", grid_class: int = GRID_CLASS_FOG,
               background: float = 0.0, codec: int = CODEC_NONE) -> int:
    """Write a float grid as a single-segment .nvdb file. `values` is
    [D, H, W] in (z, y, x) order. Voxels equal to `background` become
    inactive; all-background leaves are pruned from the tree. Returns the
    grid blob size in bytes."""
    values = np.asarray(values, np.float32)
    if values.ndim != 3:
        raise ValueError("values must be [D, H, W]")
    ijk_min = np.asarray(ijk_min, np.int32)
    voxel_size = np.broadcast_to(np.asarray(voxel_size, np.float64),
                                 (3,)).copy()
    translation = np.asarray(translation, np.float64)
    dims_xyz = np.asarray(values.shape[::-1], np.int32)
    if (ijk_min % 8).any():
        raise ValueError("ijk_min must be 8-aligned (leaf lattice)")

    # pad to the leaf lattice; canvas [bz,by,bx][z,y,x]
    ext = -(-dims_xyz // 8) * 8
    padded = np.full((ext[2], ext[1], ext[0]), background, np.float32)
    padded[:values.shape[0], :values.shape[1], :values.shape[2]] = values
    nb = ext // 8
    canvas = padded.reshape(nb[2], 8, nb[1], 8, nb[0], 8
                            ).transpose(0, 2, 4, 1, 3, 5)
    active_blk = (canvas != background).any(axis=(3, 4, 5))   # [bz,by,bx]
    bz, by, bx = np.nonzero(active_blk)
    n_leaf = len(bz)
    if n_leaf == 0:
        raise ValueError("grid has no active voxels")
    leaf_org = (np.stack([bx, by, bz], -1).astype(np.int32) * 8
                + ijk_min)                                    # xyz

    leaves = np.zeros(n_leaf, _LEAF_DT)
    lvals = canvas[bz, by, bx]                                # [N][z,y,x]
    active = lvals != background
    # active-voxel bbox per leaf (any inactive voxel inside stays 0-filled)
    az, ay, ax = (active.any(axis=(1, 2)), active.any(axis=(0, 2)),
                  active.any(axis=(0, 1)))

    def _minmax(m):  # [N, 8] -> first/last set index
        idx = np.arange(8)
        first = np.where(m, idx, 8).min(axis=1)
        last = np.where(m, idx, -1).max(axis=1)
        return first.astype(np.int32), last.astype(np.int32)

    fz, lz = _minmax(active.any(axis=(2, 3)))
    fy, ly = _minmax(active.any(axis=(1, 3)))
    fx, lx = _minmax(active.any(axis=(1, 2)))
    del az, ay, ax
    leaves["bbox_min"] = leaf_org + np.stack([fx, fy, fz], -1)
    leaves["bbox_dif"] = np.stack([lx - fx, ly - fy, lz - fz],
                                  -1).astype(np.uint8)
    # value order x-major
    leaves["values"] = lvals.transpose(0, 3, 2, 1).reshape(n_leaf, 512)
    bits = np.packbits(active.transpose(0, 3, 2, 1).reshape(n_leaf, 512),
                       axis=1, bitorder="little")
    leaves["value_mask"] = bits.view("<u8")
    amask = np.where(active.transpose(0, 3, 2, 1).reshape(n_leaf, 512),
                     leaves["values"], np.nan)
    leaves["minimum"] = np.nanmin(amask, axis=1)
    leaves["maximum"] = np.nanmax(amask, axis=1)
    leaves["average"] = np.nanmean(amask, axis=1)
    leaves["stddev"] = np.nan_to_num(np.nanstd(amask, axis=1))

    # group leaves into lower nodes (128-span), lowers into uppers (4096)
    def _group(child_org: np.ndarray, span: int):
        org = (child_org // span) * span
        uniq, inv = np.unique(org, axis=0, return_inverse=True)
        return uniq.astype(np.int32), inv

    lower_orgs, leaf_parent = _group(leaf_org, 128)
    upper_orgs, lower_parent = _group(lower_orgs, 4096)
    n_lower, n_upper = len(lower_orgs), len(upper_orgs)

    lowers = np.zeros(n_lower, _LOWER_DT)
    uppers = np.zeros(n_upper, _UPPER_DT)
    leaf_bbox_lo = leaves["bbox_min"]
    leaf_bbox_hi = leaf_bbox_lo + leaves["bbox_dif"].astype(np.int32)

    def _set_children(nodes, parent_idx, child_org, log2dim, node_orgs,
                      stats, child_lo, child_hi):
        # lower (log2dim 4): child span 8; upper (log2dim 5): 128
        child_span = 8 if log2dim == 4 else 128
        for i, node in enumerate(nodes):
            kids = np.nonzero(parent_idx == i)[0]
            local = (child_org[kids] - node_orgs[i]) // child_span
            n = ((local[:, 0] << (2 * log2dim)) + (local[:, 1] << log2dim)
                 + local[:, 2])
            cm = np.zeros(1 << (3 * log2dim), bool)
            cm[n] = True
            node["child_mask"] = np.packbits(
                cm, bitorder="little").view("<u8")
            node["table"][n] = kids.astype(np.uint32)
            node["minimum"] = stats["minimum"][kids].min()
            node["maximum"] = stats["maximum"][kids].max()
            node["average"] = stats["average"][kids].mean()
            node["bbox"][:3] = child_lo[kids].min(axis=0)
            node["bbox"][3:] = child_hi[kids].max(axis=0)

    _set_children(lowers, leaf_parent, leaf_org, 4, lower_orgs, leaves,
                  leaf_bbox_lo, leaf_bbox_hi)
    _set_children(uppers, lower_parent, lower_orgs, 5, upper_orgs, lowers,
                  lowers["bbox"][:, :3], lowers["bbox"][:, 3:])

    # lower/upper mOffset: child array base in units of own node size
    # (`NanoVDB.h:2550`: (ChildT*)(this + mOffset) + childID)
    tiles = np.zeros(n_upper, _TILE_DT)
    # CoordToKey casts each coordinate to uint32 BEFORE shifting
    # (`NanoVDB.h:2201-2206`) — negative origins wrap to 20-bit fields
    u32 = (upper_orgs.astype(np.int64)
           & 0xFFFFFFFF).astype(np.uint64)       # [N, 3] xyz as uint32
    key = ((u32[:, 2] >> np.uint64(12))
           | ((u32[:, 1] >> np.uint64(12)) << np.uint64(21))
           | ((u32[:, 0] >> np.uint64(12)) << np.uint64(42)))
    order = np.argsort(key, kind="stable")       # findTile binary search
    tiles["key"] = key[order]
    tiles["child_id"] = np.arange(n_upper, dtype=np.int32)[order]

    # ---- assemble the blob ----
    tree_off = GRIDDATA_SIZE
    root_off = tree_off + TREEDATA_SIZE
    tiles_off = root_off + ROOTDATA_SIZE
    upper_off = tiles_off + n_upper * ROOT_TILE_SIZE  # root.child: no gap
    lower_off = upper_off + n_upper * UPPER_SIZE
    leaf_off = lower_off + n_lower * LOWER_SIZE
    grid_size = leaf_off + n_leaf * LEAF_SIZE
    uppers["offset"] = ((lower_off - upper_off) // UPPER_SIZE
                        - np.arange(n_upper))
    lowers["offset"] = ((leaf_off - lower_off) // LOWER_SIZE
                        - np.arange(n_lower))

    active_bbox_min = leaf_bbox_lo.min(axis=0)
    active_bbox_max = leaf_bbox_hi.max(axis=0)
    voxel_count = int(np.unpackbits(
        leaves["value_mask"].view(np.uint8)).sum())
    world_lo = translation + active_bbox_min * voxel_size
    world_hi = translation + (active_bbox_max + 1) * voxel_size

    blob = bytearray(grid_size)
    # GridData
    struct.pack_into("<QQ", blob, 0, MAGIC, 0)        # magic, checksum
    struct.pack_into("<II", blob, 16, (ABI << 21), 2 | 4)  # ver, BBox|MinMax
    struct.pack_into("<Q", blob, 24, grid_size)
    nm = name.encode()[:255]
    blob[32:32 + len(nm)] = nm
    # Map: diag scale + translation, float then double blocks
    vs = voxel_size
    matf = np.zeros(9, np.float32)
    matf[::4] = vs
    imatf = np.zeros(9, np.float32)
    imatf[::4] = 1.0 / vs
    struct.pack_into("<9f", blob, 288, *matf)
    struct.pack_into("<9f", blob, 324, *imatf)
    struct.pack_into("<3ff", blob, 360, *translation.astype(np.float32), 0.0)
    matd = np.zeros(9, np.float64)
    matd[::4] = vs
    imatd = np.zeros(9, np.float64)
    imatd[::4] = 1.0 / vs
    struct.pack_into("<9d", blob, 376, *matd)
    struct.pack_into("<9d", blob, 448, *imatd)
    struct.pack_into("<3dd", blob, 520, *translation, 0.0)
    struct.pack_into("<6d", blob, 552, *world_lo, *world_hi)
    struct.pack_into("<3d", blob, 600, *voxel_size)
    struct.pack_into("<II", blob, 624, grid_class, GRID_TYPE_FLOAT)
    struct.pack_into("<QI", blob, 632, 0, 0)          # no blind data
    # TreeData
    struct.pack_into("<4Q", blob, tree_off,
                     leaf_off - tree_off, lower_off - tree_off,
                     upper_off - tree_off, root_off - tree_off)
    struct.pack_into("<4I", blob, tree_off + 32, n_leaf, n_lower, n_upper, 1)
    struct.pack_into("<4I", blob, tree_off + 48, n_leaf, n_lower, n_upper, 0)
    # RootData
    struct.pack_into("<6i", blob, root_off, *active_bbox_min,
                     *active_bbox_max)
    struct.pack_into("<QI", blob, root_off + 24, voxel_count, n_upper)
    struct.pack_into("<5f", blob, root_off + 36, background,
                     float(leaves["minimum"].min()),
                     float(leaves["maximum"].max()),
                     float(leaves["average"].mean()), 0.0)
    blob[tiles_off:upper_off] = tiles.tobytes()
    blob[upper_off:lower_off] = uppers.tobytes()
    blob[lower_off:leaf_off] = lowers.tobytes()
    blob[leaf_off:grid_size] = leaves.tobytes()

    # ---- file header + metadata (`IO.h:105-160`) ----
    if codec == CODEC_NONE:
        payload = bytes(blob)
        file_size = grid_size
    elif codec == CODEC_ZIP:
        comp = zlib.compress(bytes(blob))
        payload = struct.pack("<Q", len(comp)) + comp
        file_size = len(comp)
    else:
        raise NotImplementedError(f"codec {codec}")
    meta = bytearray(160)
    struct.pack_into("<4Q", meta, 0, grid_size, file_size, 0, voxel_count)
    struct.pack_into("<II", meta, 32, GRID_TYPE_FLOAT, grid_class)
    struct.pack_into("<6d", meta, 40, *world_lo, *world_hi)
    struct.pack_into("<6i", meta, 88, *active_bbox_min, *active_bbox_max)
    struct.pack_into("<3d", meta, 112, *voxel_size)
    name_b = name.encode() + b"\0"
    struct.pack_into("<I", meta, 136, len(name_b))
    struct.pack_into("<4I", meta, 140, n_leaf, n_lower, n_upper, 1)
    struct.pack_into("<H", meta, 156, codec)
    header = struct.pack("<QIHH", MAGIC, (ABI << 21), 1, codec)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(bytes(meta))
        f.write(name_b)
        f.write(payload)
    os.replace(tmp, path)
    return grid_size
