"""Host-side Scene: the `sutil::Scene` equivalent.

Mirrors the reference's container + bring-up flow (`SDK/sutil/Scene.h:53-160`):
`add_mesh`/`add_material`/`add_texture`/`add_camera` build host tables;
`load(path)` fills them from GLTF (`Scene.cpp:267-560` loadScene); and
`finalize()` does the whole render-pipeline bring-up (`Scene.cpp:667-690`:
buildMeshAccels → buildInstanceAccel → module/program-groups/SBT) — here:
bake node transforms into world space, concatenate meshes with disjoint
material ids, pack textures, build the LBVH for big geometry, and emit the
DeviceScene pytree the wavefront engine consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.camera import Camera
from ..shade import materials as mats
from .device_scene import DeviceScene, make_device_scene
from .gltf import load_gltf

@dataclasses.dataclass
class MeshEntry:
    positions: np.ndarray
    indices: np.ndarray
    normals: Optional[np.ndarray]
    uvs: Optional[np.ndarray]
    material: object    # int or per-triangle int array
    transform: np.ndarray     # [4, 4]
    name: str = ""



def _mesh_tri_mat(m) -> np.ndarray:
    """Per-triangle material ids of a mesh entry: `material` may be one int
    (the common case) or a per-triangle array (multi-material meshes — the
    per-SBT-record role of multiple buildInput flags, `Scene.cpp:1154`)."""
    if np.ndim(m.material) == 0:
        return np.full(len(m.indices), m.material, np.int32)
    arr = np.asarray(m.material, np.int32)
    assert arr.shape == (len(m.indices),), (arr.shape, len(m.indices))
    return arr


class Scene:
    def __init__(self):
        self.meshes: list[MeshEntry] = []
        self.materials: list[dict] = []
        self.textures: list[np.ndarray] = []
        self.cameras: list[Camera] = []
        self.lights: list[dict] = []
        # (mesh_index, 4x4 transform, sbt_offset) — explicit IAS instances
        # over shared meshes (Scene.cpp:1134-1213 buildInstanceAccel).
        self.instances: list[tuple] = []
        self.miss_color = (0.05, 0.05, 0.12)

    # --- builders (Scene.h:86-103 addMesh/addMaterial/addImage/addCamera) ---
    def add_material(self, material: dict) -> int:
        self.materials.append(dict(material))
        return len(self.materials) - 1

    def add_texture(self, image: np.ndarray) -> int:
        self.textures.append(np.asarray(image))
        return len(self.textures) - 1

    def add_mesh(self, positions, indices, normals=None, uvs=None,
                 material=0, transform=None, name="") -> int:
        self.meshes.append(MeshEntry(
            positions=np.asarray(positions, np.float32),
            indices=np.asarray(indices, np.int32).reshape(-1, 3),
            normals=None if normals is None else np.asarray(normals, np.float32),
            uvs=None if uvs is None else np.asarray(uvs, np.float32),
            material=material,
            transform=(np.eye(4, dtype=np.float32) if transform is None
                       else np.asarray(transform, np.float32)),
            name=name))
        return len(self.meshes) - 1

    def add_camera(self, camera: Camera):
        self.cameras.append(camera)

    def add_instance(self, mesh_index: int, transform=None,
                     sbt_offset: int = 0) -> int:
        """Instance a previously added mesh under a world transform — one
        `OptixInstance` (`optix_types.h:970-1010`). Once any instance
        exists, finalize() keeps meshes in object space and emits the
        two-level (IAS over shared GAS) DeviceScene: instance transforms
        can then be updated per frame with a functional replace, no
        geometry rebuild."""
        t = (np.eye(4, dtype=np.float32) if transform is None
             else np.asarray(transform, np.float32))
        self.instances.append((int(mesh_index), t, int(sbt_offset)))
        return len(self.instances) - 1

    def add_light(self, light: dict):
        self.lights.append(dict(light))

    # --- GLTF load (Scene.cpp:267-560) ---
    @classmethod
    def load(cls, path: str, time: Optional[float] = None,
             animation: int = 0) -> "Scene":
        """Load a .gltf/.glb/.obj/.ply model.

        time: pose GLTF node animations + skins at this second (None =
        bind/static pose). Re-calling with a new time re-poses; the device
        scene's triangle count is unchanged, so per-frame geometry flows
        through the jittable refit path (optixDynamicGeometry role)."""
        import os
        if os.path.splitext(path)[1].lower() in (".obj", ".ply"):
            # assimp-format role (imgui_test/triangle_gas.cpp:77): native
            # C++ parser with numpy fallback (io/meshio.py)
            from ..io.meshio import load_mesh
            v, f, n, uv = load_mesh(path)
            scene = cls()
            scene.add_material({"kind": mats.DIFFUSE,
                                "base_color": (0.75, 0.75, 0.75)})
            scene.add_mesh(v, f, normals=n, uvs=uv, material=0)
            return scene
        g = load_gltf(path)
        scene = cls()
        for m in g.materials:
            base = m.base_color
            kind = (mats.PBR if (m.metallic > 0.0 or m.base_color_texture >= 0)
                    else mats.DIFFUSE)
            scene.add_material({
                "kind": kind,
                "base_color": tuple(base[:3]),
                "metallic": m.metallic,
                "roughness": m.roughness,
                "emission": tuple(m.emissive),
                "base_tex": m.base_color_texture,
                "normal_tex": m.normal_texture,
                "mr_tex": m.mr_texture,
                "emissive_tex": m.emissive_texture,
                "alpha_mode": (mats.ALPHA_MASK if m.alpha_mode == "MASK"
                               else mats.ALPHA_BLEND if m.alpha_mode == "BLEND"
                               else mats.ALPHA_OPAQUE),
                "alpha_cutoff": m.alpha_cutoff,
                # MASK materials cut against the base-color texture's alpha
                # (glTF semantics; the reference's anyhit texture mask —
                # optixRaycasting.cu:89 __anyhit__texture_mask)
                "cutout": (mats.CUT_TEXTURE if m.alpha_mode == "MASK"
                           else mats.CUT_NONE),
            })
        if not scene.materials:
            scene.add_material({"kind": mats.DIFFUSE,
                                "base_color": (0.7, 0.7, 0.7)})
        for t in g.textures:
            scene.add_texture(t)
        posed = None
        if time is not None and (g.animations or g.skins):
            from .gltf import pose_meshes
            posed = {mi: (p, n) for mi, p, n in
                     pose_meshes(g, time, animation=animation)}
        for i, mesh in enumerate(g.meshes):
            if posed is not None and i in posed:
                p, n = posed[i]
                scene.add_mesh(p, mesh.indices, n, mesh.uvs,
                               material=max(mesh.material, 0),
                               name=mesh.name)   # already world-space
            else:
                scene.add_mesh(mesh.positions, mesh.indices, mesh.normals,
                               mesh.uvs,
                               material=max(mesh.material, 0),
                               transform=mesh.transform, name=mesh.name)
        from ..shade.lights import DIRECTIONAL, POINT
        for li in g.lights:
            # KHR_lights_punctual: point lights sit at the node origin,
            # directional lights shine down the node's -Z.
            if li.kind == "point":
                scene.lights.append({
                    "kind": POINT,
                    "position": tuple(float(x) for x in li.transform[:3, 3]),
                    "color": tuple(c * li.intensity for c in li.color)})
            elif li.kind == "directional":
                d = -li.transform[:3, 2]
                scene.lights.append({
                    "kind": DIRECTIONAL,
                    "direction": tuple(float(x) for x in d),
                    "color": tuple(c * li.intensity for c in li.color)})
        for cam in g.cameras:
            # GLTF camera looks down -Z of its node transform.
            eye = cam.transform[:3, 3]
            fwd = -cam.transform[:3, 2]
            up = cam.transform[:3, 1]
            scene.cameras.append(Camera(
                eye=tuple(eye), lookat=tuple(eye + fwd), up=tuple(up),
                fov_y=float(np.degrees(cam.yfov)), aspect=cam.aspect))
        return scene

    # --- bounds (sutil::Scene::aabb) ---
    def aabb(self):
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for m in self.meshes:
            world = m.positions @ m.transform[:3, :3].T + m.transform[:3, 3]
            lo = np.minimum(lo, world.min(axis=0))
            hi = np.maximum(hi, world.max(axis=0))
        return lo, hi

    def default_camera(self, width, height) -> Camera:
        """GLTF camera if present, else frame the scene AABB (the
        meshviewer's fallback camera bring-up)."""
        if self.cameras:
            cam = dataclasses.replace(self.cameras[0])
            cam.aspect = width / height
            return cam
        lo, hi = self.aabb()
        center = 0.5 * (lo + hi)
        extent = float(np.linalg.norm(hi - lo))
        eye = center + np.array([0.6, 0.45, 1.5]) * extent
        return Camera(eye=tuple(eye), lookat=tuple(center),
                      up=(0, 1, 0), fov_y=35.0, aspect=width / height)

    # --- finalize (Scene.cpp:667-690) ---
    def finalize(self, lights=None, area_light=None) -> DeviceScene:
        if self.instances:
            return self._finalize_instanced(lights, area_light)
        all_pos, all_idx, all_n, all_uv, tri_mat = [], [], [], [], []
        base = 0
        for m in self.meshes:
            rot = m.transform[:3, :3]
            world = m.positions @ rot.T + m.transform[:3, 3]
            all_pos.append(world.astype(np.float32))
            all_idx.append(m.indices + base)
            if m.normals is not None:
                inv_t = np.linalg.inv(rot).T
                n = m.normals @ inv_t.T
                n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                                1e-20)
            else:
                n = None
            all_n.append(n)
            all_uv.append(m.uvs)
            tri_mat.append(_mesh_tri_mat(m))
            base += len(m.positions)

        if not all_pos:
            all_pos = [np.zeros((3, 3), np.float32)]
            all_idx = [np.zeros((1, 3), np.int32)]
            all_n = [None]
            all_uv = [None]
            tri_mat = [np.zeros(1, np.int32)]

        positions = np.concatenate(all_pos)
        indices = np.concatenate(all_idx)
        tri_mat = np.concatenate(tri_mat)

        # attributes: fill defaults where a mesh lacks them
        have_normals = any(n is not None for n in all_n)
        have_uvs = any(u is not None for u in all_uv)
        normals = None
        uvs = None
        if have_normals:
            parts = []
            for p, n in zip(all_pos, all_n):
                parts.append(n if n is not None
                             else np.zeros_like(p))
            normals = np.concatenate(parts)
            # zero normals (meshes that shipped none) → shading_frame
            # falls back to the geometric face normal per hit
        if have_uvs:
            parts = []
            for p, u in zip(all_pos, all_uv):
                parts.append(u if u is not None
                             else np.zeros((len(p), 2), np.float32))
            uvs = np.concatenate(parts)

        return make_device_scene(
            positions, indices, tri_mat,
            self.materials or [{"kind": mats.DIFFUSE}],
            lights=lights if lights is not None else self.lights,
            area_light=area_light,
            miss_color=self.miss_color,
            normals=normals, uvs=uvs, textures=self.textures)

    def _finalize_instanced(self, lights, area_light) -> DeviceScene:
        """Two-level finalize: meshes stay in OBJECT space (their own
        MeshEntry.transform baked as a pre-transform), shared GAS =
        concatenation of the referenced meshes, and every instance points
        at its mesh's static triangle range. Meshes not referenced by any
        instance get an implicit identity instance so mixed scenes work —
        the `buildInstanceAccel` flow of `Scene.cpp:1134-1213`."""
        from ..accel.tlas import make_instances

        inst = list(self.instances)
        used = {mi for mi, _, _ in inst}
        for mi in range(len(self.meshes)):
            if mi not in used:
                inst.append((mi, np.eye(4, dtype=np.float32), 0))

        order = sorted({mi for mi, _, _ in inst})
        ranges = {}
        all_pos, all_idx, all_n, all_uv, tri_mat = [], [], [], [], []
        vbase = 0
        tbase = 0
        for mi in order:
            m = self.meshes[mi]
            rot = m.transform[:3, :3]
            obj = m.positions @ rot.T + m.transform[:3, 3]
            all_pos.append(obj.astype(np.float32))
            all_idx.append(m.indices + vbase)
            if m.normals is not None:
                inv_t = np.linalg.inv(rot).T
                n = m.normals @ inv_t.T
                n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                                1e-20)
            else:
                n = None
            all_n.append(n)
            all_uv.append(m.uvs if m.uvs is not None
                          else np.zeros((len(obj), 2), np.float32))
            tri_mat.append(_mesh_tri_mat(m))
            ranges[mi] = (tbase, tbase + len(m.indices))
            vbase += len(m.positions)
            tbase += len(m.indices)

        table = make_instances(
            [t for _, t, _ in inst],
            sbt_offsets=np.asarray([s for _, _, s in inst], np.int32),
            prim_ranges=[ranges[mi] for mi, _, _ in inst])

        return make_device_scene(
            np.concatenate(all_pos), np.concatenate(all_idx),
            np.concatenate(tri_mat),
            self.materials or [{"kind": mats.DIFFUSE}],
            lights=lights if lights is not None else self.lights,
            area_light=area_light,
            miss_color=self.miss_color,
            normals=(np.concatenate(
                [n if n is not None else np.zeros((len(p), 3), np.float32)
                 for p, n in zip(all_pos, all_n)])
                if any(n is not None for n in all_n) else None),
            uvs=np.concatenate(all_uv),
            textures=self.textures, instances=table)
