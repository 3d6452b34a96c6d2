"""Every public top-level function and class of the JAX package has a
namesake in the port's module of the same relative path, or stands in
``NOT_PORTED`` with the reason. Read with ``ast``: nothing is imported.
``ROADMAP.md`` carries the same table ("Not ported, and why")."""

import ast
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# "<module path under enerf_tpu/, without .py>.<name>": why the port has no
# namesake there
NOT_PORTED = {
    "eval/lpips_jax.lpips_skip_notice": "ported as eval/lpips.py (the module named for torch)",
    "eval/lpips_jax.load_lpips_params": "eval/lpips.py:load_lpips loads the same npz into a module",
    "eval/lpips_jax.export_lpips_npz": "writes the npz from the lpips package's torch weights: a download",
    "eval/lpips_jax.lpips": "eval/lpips.py:LPIPS, an nn.Module",
    "models/layers.torch_conv_kernel_init": "torch's own Conv init is the one it copies",
    "models/layers.torch_linear_kernel_init": "torch's own Linear init is the one it copies",
    "models/layers.kaiming_normal_init": "torch.nn.init.kaiming_normal_ (models/layers.py:init_weights)",
    "models/layers.BatchNorm": "torch's nn.BatchNorm2d/3d (SyncBatchNorm2d/3d across ranks)",
    "models/layers.ConvTranspose3dTorch": "torch's nn.ConvTranspose3d, whose semantics it copies",
    "models/layers.torch_convtranspose_kernel_init": "torch's own ConvTranspose init is the one it copies",
    "ops/ibr.packed_feat_layout": "TPU VMEM gather layout",
    "ops/ibr.seg_geom_layout": "TPU VMEM gather layout",
    "ops/ibr.get_img_feat_segments": "TPU segmented gather; ops/ibr.py:get_img_feat samples with F.grid_sample",
    "ops/ibr.get_img_feat_packed": "TPU packed gather; ops/ibr.py:get_img_feat samples with F.grid_sample",
    "ops/pallas/__init__.compiler_options": "XLA compiler flags of the Pallas kernels",
    "ops/pallas/__init__.fused_available": "Pallas backend probe; a CUDA tensor always takes its kernel",
    "ops/pallas/__init__.fused_vmem_tile": "TPU VMEM budget",
    "ops/pallas/cost_volume.fused_corner_variance": "K1: csrc/cost_volume.cu through ops/kernels/cost_volume.py",
    "ops/pallas/cost_volume.volume_tile": "TPU VMEM tiling of K1",
    "ops/pallas/cost_volume.fused_wide_variance": "K1w, K1 over another TPU gather layout: csrc/cost_volume.cu",
    "ops/pallas/cost_volume.volume_tile_wide": "TPU VMEM tiling of K1w",
    "ops/pallas/reductions.depth_regression_pallas": "K4: csrc/depth_regression.cu through ops/kernels/depth_regression.py",
    "ops/pallas/reductions.depth_regression_fused": "K4 with its plain backward: ops/kernels/depth_regression.py",
    "ops/pallas/render.render_rays_packed_xla": "K3: autograd over ops/kernels/render.py:render_rays_plain",
    "ops/pallas/render.fused_render_rays": "K2 / K2-L0: csrc/render.cu, csrc/render_l0.cu through ops/kernels/render.py",
    "ops/pallas/render.head_params_packed": "TPU operand packing of K2's weights",
    "ops/pallas/render.blend_consts": "TPU operand packing of K2's constants",
    "ops/pallas/render.tent_consts": "TPU operand packing of K2's constants",
    "ops/pallas/render.blend_consts_k": "TPU operand packing of K2's constants",
    "ops/pallas/render.misc_consts_k": "TPU operand packing of K2's constants",
    "ops/pallas/render.head_params_packed_k": "TPU operand packing of K2's weights",
    "ops/rays.gather_ray_bounds": "inlined in ops/rays.py:build_rays (a tensor index)",
    "ops/sampling.take_rows_segmented": "TPU VMEM-pinned gather",
    "ops/sampling.take_rows": "TPU row gather; a tensor index",
    "ops/sampling.bilinear_sample_2d": "F.grid_sample (bilinear_sample_2d_multi); ops/warp.py:_bilinear_zeros",
    "ops/sampling.corner_rows_2d": "TPU packed corner gather",
    "ops/sampling.pack_gather_table_2d": "TPU VMEM gather table",
    "ops/sampling.packed_row_index": "TPU VMEM gather table",
    "ops/sampling.corner_gather_perview": "TPU gather feeding the Pallas K1",
    "ops/sampling.pack_gather_table_wide": "TPU VMEM gather table",
    "ops/sampling.corner_blend_wide": "TPU wide-table gather",
    "ops/sampling.wide_table_segments": "TPU VMEM gather table",
    "ops/sampling.corner_gather_segments": "TPU wide-table gather",
    "ops/sampling.bilinear_sample_2d_view_last": "TPU lane layout of bilinear_sample_2d_multi",
    "ops/sampling.grid_sample_2d": "torch's F.grid_sample",
    "ops/sampling.trilinear_sample_3d": "F.grid_sample (trilinear_sample_3d_multi)",
    "ops/sampling.grid_sample_3d": "torch's F.grid_sample",
    "ops/sampling.resize_trilinear": "F.interpolate(trilinear, align_corners=True), as MinCostRegNetTri calls it",
    "ops/sampling.resize_nearest": "F.interpolate(nearest); utils/cv.py:resize_by on the host",
    "parallel/mesh.make_mesh": "JAX device mesh; one process a card (parallel/dist.py)",
    "parallel/mesh.batch_sharding": "JAX sharding; DDP splits the batch by rank",
    "parallel/mesh.replicate_sharding": "JAX sharding; DDP replicates the model",
    "parallel/mesh.mesh_size": "JAX device mesh; parallel/dist.py:world_size",
    "parallel/mesh.shard_batch": "JAX sharding; each rank loads its own slice",
    "parallel/mesh.local_batch_slice": "parallel/dist.py:local_batch_slice",
    "train/step.replicate_state": "JAX sharding; DDP replicates the model",
    "train/step.make_bn_refresh_step": "XLA pathology: the port updates BN statistics in its train step",
    "train/step.make_eval_step": "a jit of the eval forward; run.py:load_eval_model under inference_mode",
    "train/vgg.export_torchvision_npz": "writes the npz from torchvision's weights: a download",
    "train/vgg.vgg16_block_features": "train/vgg.py:VGG16Blocks, an nn.Module",
    "utils/convert.torch_to_flax": "JAX-side direction",
    "utils/convert.flax_to_torch": "utils/convert.py:flax_state_dict",
    "utils/convert.load_torch_checkpoint": "a reference .pth is a torch state dict under the port's names: torch.load",
    "utils/profiling.perf_timer": "synchronizing stopwatches; the port's spans (`profiling.span`) replace them",
    "utils/profiling.time_fn": "synchronizing stopwatches; the port's spans (`profiling.span`) replace them",
    "utils/profiling.setup_compile_cache": "JAX's compile cache; kernels are cached by source hash in build/kernels",
    "utils/profiling.frame_latency_fori": "TPU block_until_ready returns early; CUDA events wait for the card",
}


def _public(path: Path):
    """Public top-level functions and classes of a module."""
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _bound(path: Path):
    """Every top-level name a module binds (def, class, assignment)."""
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
    return names


def test_every_public_name_is_ported_or_listed():
    missing, listed_but_ported = [], []
    seen = set()
    for path in sorted((REPO / "enerf_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "enerf_tpu")
        port = REPO / "enerf_tpu_torch" / rel
        have = _bound(port) if port.is_file() else set()
        for name in _public(path):
            key = f"{rel.with_suffix('').as_posix()}.{name}"
            seen.add(key)
            if name in have:
                if key in NOT_PORTED:
                    listed_but_ported.append(key)
            elif key not in NOT_PORTED:
                missing.append(key)
    assert not missing, f"public names with no port and no reason: {missing}"
    assert not listed_but_ported, listed_but_ported
    assert not set(NOT_PORTED) - seen, sorted(set(NOT_PORTED) - seen)
    for key, why in NOT_PORTED.items():
        assert why.strip() and "later" not in why.lower(), key
