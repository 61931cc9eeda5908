"""Terrain: quadtree LOD chunks, height queries, vegetation scatter.

Counterpart of ``substrata_tpu/physics/terrain.py`` (K17; the reference's
gui_client/TerrainSystem, TerrainScattering and BiomeManager).  The host
code (the quadtree refined against the camera, the scatter cells kept
around it, the tree physics objects, the parcel biomes) is the reference's.
The device work is kernel KW (``kernels/terrain.py``: height queries and
chunk meshes) and kernel KX (the scatter points), each twin on the CPU.

Copies: a height query is one launch and one read back.  The reference
makes one jitted call and one read per new quadtree leaf; here
``update_campos`` builds every new leaf of the call in ONE KW launch and
reads them back in one copy (leaf ids and build order unchanged), and
``TerrainScattering.update_campos`` makes one KX launch and one read, as
the reference does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from substrata_tpu_torch.device import resolve_device
from substrata_tpu_torch.kernels import terrain as kterrain


@dataclass
class TerrainField:
    """The terrain's heightfield on the device (the reference's
    physics.state.Heightfield as TerrainSystem holds it)."""

    heights: torch.Tensor   # [HX, HY] f32
    origin: torch.Tensor    # [2] f32
    cell_w: torch.Tensor    # [] f32

    def heights_at(self, xy: torch.Tensor, with_normals: bool = False) -> torch.Tensor:
        """KW: [P, 1] heights (or [P, 4] with the unit normals) at xy [P, 2]."""
        return kterrain.terrain_heights(self.heights, self.origin, self.cell_w, xy,
                                        with_normals)


@dataclass(eq=False)
class TerrainNode:
    """TerrainSystem.h TerrainNode: a quadtree cell, subdivided near the
    camera."""

    origin: np.ndarray       # xy of min corner
    width: float
    depth: int
    children: list = field(default_factory=list)
    chunk: tuple | None = None   # (verts, normals, uvs, tris) when leaf built
    id: int = 0

    @property
    def is_leaf(self):
        return not self.children


class TerrainSystem:
    """Host orchestrator for terrain: owns the device heightfield, refines a
    quadtree against the camera position, builds chunk meshes on demand and
    registers the heightfield with the physics world.  Lives on the physics
    world's device, or on ``device`` (default the card) without one."""

    MAX_DEPTH = 6
    # Subdivide when camera is closer than width * this factor
    # (quadtree refinement distance ratio, TerrainSystem updateCampos).
    REFINE_FACTOR = 1.5

    def __init__(self, physics_world=None, extent: float = 1024.0,
                 chunk_res: int = 16, *, device=None):
        self.physics_world = physics_world
        self.device = (physics_world.device if physics_world is not None
                       else resolve_device(device or "cuda"))
        self.extent = extent
        self.chunk_res = chunk_res
        self.heightfield: TerrainField | None = None
        self.water_z = -1e10
        self.root = TerrainNode(origin=np.array([-extent / 2, -extent / 2]),
                                width=extent, depth=0)
        self._next_id = 1
        self.built_chunks: dict[int, tuple] = {}
        self.num_chunks_built = 0

    def set_heightmap(self, heights: np.ndarray, origin, cell_w: float):
        dev = self.device
        self.heightfield = TerrainField(
            heights=torch.as_tensor(np.ascontiguousarray(heights, np.float32), device=dev),
            origin=torch.as_tensor(np.asarray(origin, np.float32), device=dev),
            cell_w=torch.tensor(float(np.float32(cell_w)), dtype=torch.float32, device=dev))
        if self.physics_world is not None:
            self.physics_world.set_heightfield(heights, origin, cell_w)

    # evalTerrainHeight parity (TerrainSystem.h:190).
    def eval_terrain_height(self, x: float, y: float) -> float:
        if self.heightfield is None:
            return 0.0
        return float(self.eval_terrain_heights(np.array([[x, y]], np.float32))[0])

    def eval_terrain_heights(self, xy: np.ndarray) -> np.ndarray:
        """Batched height query (used by scattering + the player clamp):
        one pinned upload of the points, one KW launch, one read back."""
        if self.heightfield is None:
            return np.zeros(len(xy), np.float32)
        pts = self._upload(np.asarray(xy, np.float32).reshape(-1, 2))
        return self.heightfield.heights_at(pts).cpu().numpy()[:, 0]

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the terrain's device; on the card through pinned
        memory with a non-blocking copy (the read that follows orders it)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t if self.device.type == "cpu" else t.pin_memory().to(self.device,
                                                                      non_blocking=True)

    # ------------------------------------------------------------------
    def update_campos(self, campos):
        """Refine/coarsen the quadtree around the camera and build leaf
        chunk meshes (updateCampos parity)."""
        if self.heightfield is None:
            return
        cam = np.asarray(campos[:2], np.float64)
        self._refine(self.root, cam)
        self._build_leaves()

    def _refine(self, node: TerrainNode, cam):
        centre = node.origin + node.width / 2
        dist = float(np.linalg.norm(cam - centre))
        want_split = (dist < node.width * self.REFINE_FACTOR
                      and node.depth < self.MAX_DEPTH)
        if want_split and node.is_leaf:
            hw = node.width / 2
            node.chunk = None
            node.children = [
                TerrainNode(origin=node.origin + np.array([dx * hw, dy * hw]),
                            width=hw, depth=node.depth + 1)
                for dx in (0, 1) for dy in (0, 1)]
        elif not want_split and not node.is_leaf:
            node.children = []
            node.chunk = None
        for c in node.children:
            self._refine(c, cam)

    def _unbuilt_leaves(self, node: TerrainNode, out: list):
        if node.is_leaf:
            if node.chunk is None:
                out.append(node)
        else:
            for c in node.children:
                self._unbuilt_leaves(c, out)
        return out

    def _build_leaves(self):
        """Every leaf without a chunk, in the reference's depth-first order,
        built in one KW launch and read back in one copy."""
        leaves = self._unbuilt_leaves(self.root, [])
        if not leaves:
            return
        leaf = self._upload(np.array([[*n.origin, n.width] for n in leaves], np.float32))
        origins, widths = leaf[:, :2].contiguous(), leaf[:, 2].contiguous()
        hf = self.heightfield
        packed = kterrain.terrain_chunks(hf.heights, hf.origin, hf.cell_w, origins, widths,
                                         self.chunk_res)
        for node, chunk in zip(leaves, kterrain.unpack_chunks(packed.cpu().numpy(),
                                                              self.chunk_res)):
            node.id = self._next_id
            self._next_id += 1
            node.chunk = chunk
            self.built_chunks[node.id] = node.chunk
            self.num_chunks_built += 1

    def visible_chunks(self):
        out = []

        def walk(node):
            if node.is_leaf and node.chunk is not None:
                out.append((node.origin, node.width, node.chunk))
            for c in node.children:
                walk(c)

        walk(self.root)
        return out

    def get_diagnostics(self) -> str:
        leaves = len(self.visible_chunks())
        return (f"TerrainSystem: {leaves} leaf chunks, "
                f"{self.num_chunks_built} built total")


@dataclass
class VegetationLocationInfo:
    """TerrainScattering.h VegetationLocationInfo: {pos, scale} (+rot)."""

    pos: np.ndarray
    scale: float
    rot: float


class TerrainScattering:
    """Camera-driven vegetation chunks (TerrainScattering updateCampos):
    cells within `radius` of the camera get scatter points; far cells are
    dropped.  Small-tree cells can register physics objects per instance
    (TerrainScattering.h:79-83)."""

    def __init__(self, terrain: TerrainSystem, cell_w: float = 32.0,
                 radius_cells: int = 4, points_per_cell: int = 64,
                 seed: int = 1234):
        self.terrain = terrain
        self.cell_w = cell_w
        self.radius_cells = radius_cells
        self.points_per_cell = points_per_cell
        self.seed = seed
        self.chunks: dict[tuple, list[VegetationLocationInfo]] = {}
        self.tree_physics_obs: dict[tuple, list] = {}
        self.make_tree_physics = None  # callback(pos, scale) -> PhysicsObject

    def update_campos(self, campos):
        """One KX launch and one read back for the cells that came into
        range; the cells that left it go, with their physics objects."""
        if self.terrain.heightfield is None:
            return
        cx = math.floor(campos[0] / self.cell_w)
        cy = math.floor(campos[1] / self.cell_w)
        r = self.radius_cells
        wanted = {(cx + dx, cy + dy) for dx in range(-r, r + 1)
                  for dy in range(-r, r + 1)}
        # Drop out-of-range chunks (+ their physics objects).
        for key in list(self.chunks):
            if key not in wanted:
                del self.chunks[key]
                for ob in self.tree_physics_obs.pop(key, []):
                    if self.terrain.physics_world is not None:
                        self.terrain.physics_world.remove_object(ob)
        new_cells = [key for key in wanted if key not in self.chunks]
        if not new_cells:
            return
        origins = self.terrain._upload(np.array(
            [[kx * self.cell_w, ky * self.cell_w] for kx, ky in new_cells], np.float32))
        hf = self.terrain.heightfield
        packed = kterrain.terrain_scatter(hf.heights, hf.origin, hf.cell_w, origins,
                                          self.cell_w, self.seed,
                                          self.points_per_cell).cpu().numpy()
        pos = packed[..., 0:3]
        scale = packed[..., 3]
        rot = packed[..., 4]
        valid = packed[..., 5] > 0.5
        for i, key in enumerate(new_cells):
            infos = [VegetationLocationInfo(pos[i, j], float(scale[i, j]),
                                            float(rot[i, j]))
                     for j in np.nonzero(valid[i])[0]]
            self.chunks[key] = infos
            if self.make_tree_physics is not None:
                obs = []
                for info in infos[:16]:  # cap physics instances per cell
                    ob = self.make_tree_physics(info.pos, info.scale)
                    if ob is not None:
                        obs.append(ob)
                self.tree_physics_obs[key] = obs

    def num_instances(self) -> int:
        return sum(len(v) for v in self.chunks.values())

    def get_diagnostics(self) -> str:
        return (f"TerrainScattering: {len(self.chunks)} cells, "
                f"{self.num_instances()} instances")


class BiomeManager:
    """Park/grass biome scattering over parcels (gui_client/BiomeManager.*):
    deterministic scatter points inside each parcel AABB, snapped to
    terrain."""

    def __init__(self, terrain: TerrainSystem, density_per_m2: float = 0.02,
                 seed: int = 99):
        self.terrain = terrain
        self.density = density_per_m2
        self.seed = seed
        self.parcel_scatter: dict[int, list[VegetationLocationInfo]] = {}

    def add_biome_for_parcel(self, parcel):
        area = float((parcel.aabb_max[0] - parcel.aabb_min[0])
                     * (parcel.aabb_max[1] - parcel.aabb_min[1]))
        n = max(1, int(area * self.density))
        rng = np.random.default_rng(self.seed ^ hash(parcel.parcel_id) & 0xFFFF)
        xy = rng.uniform(parcel.aabb_min[:2], parcel.aabb_max[:2],
                         size=(n, 2)).astype(np.float32)
        h = self.terrain.eval_terrain_heights(xy)
        infos = [VegetationLocationInfo(np.array([x, y, z], np.float32),
                                        float(rng.uniform(0.7, 1.4)),
                                        float(rng.uniform(0, 2 * np.pi)))
                 for (x, y), z in zip(xy, h)]
        self.parcel_scatter[parcel.parcel_id] = infos
        return infos

    def remove_biome_for_parcel(self, parcel_id: int):
        self.parcel_scatter.pop(parcel_id, None)
