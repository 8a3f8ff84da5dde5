#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`comfy3d_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--out RECORD.json]   # repository root, one card

Phases, in order; the first failure ends the run with a non-zero exit:
  1. the card: its name, and `nvidia-smi`'s name and power limit;
  2. build every CUDA source under comfy3d_tpu_torch/csrc with nvcc, all
     at once;
  3. the coarse-bin forward (`gs_flat_fwd`, K1′/K2′: splat rows read by
     index) against its plain version on the gathered payload, on the same
     inputs, in merged and per-sub-tile mode at 20k splats / 256² and 100k
     splats / 800², and with 48- and 64-px bins (clusters of 9 and 16
     CTAs) at 20k / 256²;
  4. the render path — a 100k-splat GS-PLY written with `save_gs_ply`,
     read back with `load_gs_ply(device="cuda")`, rendered from 8 orbit
     views at 800² with `render` — with every kernel's launch count reset
     just before and read just after; then times of a frame, the kernel,
     its plain version, the coarse sort and the gather the kernel took in,
     with CUDA events; a profile of one frame, which must gather no pair
     rows; the per-splat box on view 0 (no live visit outside it);
  5. the compositor backward with its per-splat scatter (`gs_flat_bwd`)
     against its plain version on the same scenes and modes, from the
     forward kernel's trans/stops and seeded random cotangents: each
     gradient row within 1e-3 of its largest value, the rows of splats no
     walked pair holds exactly 0, splat 0's row the sum of its own pairs'
     plain columns;
  6. the trainer learns: 64 random splats fitted to 4 views of a 4-splat
     scene at 64² for 120 steps at batch 2 (loss must fall below 0.7× its
     start);
  7. the training path at full width (`bench.py::bench_gs_train_step`'s
     set-up: 100k splats, 800², 4 orbit views, batch 1, `GSTrainConfig`
     defaults) — 10 steps with the launch counts reset just before and read
     just after, step and kernel times, a profile of one step (which must
     hold no `index_add_`, and gather the payload rows once, for the
     backward), one densify and one opacity reset, and the trained splat
     through GS-PLY and back; on the trained splat's view 0 the forward
     and backward kernels' times and bounds and the per-splat box; beside
     the backward kernel, the counts of the per-slot design on the same
     input (warp reductions, their shuffle bound, walk lengths) and the
     time of its per-step scatter (`index_add_` × 4 of the plain per-slot
     columns);
  8. the tile compositor forward and backward (`gs_tile_fwd`, K4′: splat
     rows read by index; `gs_tile_bwd`, K5′, fed the block K4′ writes)
     against their plain versions on the card, at 20k splats / 256² with
     `max_per_tile` 512 and 100k splats / 800² with 1024, the backward
     with phase 5's gates; K4′'s block equal to the gathered one below
     each tile's count;
  9. the tile render path — phase 4's GS-PLY from the same 8 views with
     `render(..., backend="tile", max_per_tile=1024)`, launch counts reset
     just before and read just after; tile-vs-flat PSNR per view and on the
     20k/256² parity scene; on that scene `render_arrays` at
     `max_per_tile=64, chunk=8` (lists padded to 128 slots) through the
     kernels against the same call through their plain versions, outputs
     and gradients with phases 3 and 5's gates, one launch of each; times of a frame, the kernel, its plain
     version, `bin_primitives` and the gather the kernel took in, a profile
     of one frame (no splat-row gather) and the per-splat box on view 0;
 10. the tile train path — the learning check of phase 6 and phase 7's 10
     steps with `GSTrainConfig(backend="tile")` (M = 512), with launch
     counts, step and kernel times, a profile of one step (no splat-row
     gather) and phase 7's view-0 measures;
 11. TripoSR image → mesh (`TripoSRPipeline`, `TripoSRConfig()` widths:
     ViT-B/16 on a 512² image, a 1,024-channel backbone over 3×32² tokens,
     40-channel 64² triplanes, a 10-layer NeRF MLP; weights from a seed).
     It reaches none of the compositor kernels. a. the card against the
     port's CPU path with TF32 off, at full width but 2 ViT and 2 backbone
     layers: scene codes, and σ and rgb at 32,768 probes, each within 1e-3
     of its largest value; b. full depth: `scene_codes` by CUDA events
     (warm-up, then 5 runs; TF32 off, then on) and peak memory; c. an
     analytic sphere (radius 0.5 in the 0.87 box) decoded hierarchically
     at 257³ and swept + welded on the card and on the CPU: equal counts
     and faces, vertices within 1e-5, area within 1 % of π, no overflow;
     d. `extract_mesh` at 256 (→ 257³) with the threshold at the 98th
     percentile of σ at 32,768 seeded probes, 2 M triangles, clipped on
     overflow (a random-weight field is a noise surface), with colours:
     the total time of one call, then its split from a profile of one
     more call (the host and device ms of each of `extract_mesh`'s
     spans: decode, sweep + weld, the copy to the host, colours, the
     host's vertex normals), counts, the overflow flag, and the mesh
     through GLB and back; e. one 128² orbit render (finite, alpha in
     [0, 1]).
 12. InstantMesh posed views → mesh (`InstantMeshPipeline`,
     `InstantMeshConfig()` widths: a camera-modulated ViT-B/16 over six
     320² views, a 16-layer 1,024-wide transformer over 3×32² tokens, 80-
     channel 64² triplanes; weights from seed 0; `bench.py::
     bench_instantmesh_wallclock`'s views and cameras). a. the card against
     the port's CPU path with TF32 off at 2 ViT + 2 transformer layers:
     triplanes, and SDF, deformation and rgb at 32,768 probes, each within
     1e-3 of its largest value; b. full depth: `forward_planes` by CUDA
     events (warm-up, then 5 runs; TF32 off, then on), the parameter count
     and peak memory; c. `marching_tets_deformed` + `weld_device` on a
     sphere's SDF over a smoothly deformed 97³ lattice, card against CPU:
     equal counts and faces, vertices within 1e-5, no overflow; d.
     `extract_mesh` at 96 (the bench's) and 129 (the default): a first call
     that climbs the capacity ladder (its rungs counted), one warm call
     timed, one more profiled by its spans (`models/instantmesh/
     pipeline.py::EXTRACT_STAGES`), counts, the capacity reached, the
     overflow flag (reported, not gated: random weights make a noise
     surface), the 96³ mesh through GLB and back.
 13. the mesh orbit renderer (`ops/mesh_render.py::render_mesh` with the
     `Mesh_Orbit_Renderer` node's defaults: 512², fovy 49.1, background 1,
     "binned"; meshes through `Mesh.device_arrays` with `face_valid`, as
     the node passes them), on a unit sphere from
     `extract_isosurface_device` at 97³ with vertex colours and a
     subdivided cube with per-face UVs onto a seeded 1024² albedo. a. one
     view of each, card against CPU: face ids equal on ≥ 99.9 % of pixels,
     image, alpha, depth, normal and viewcos within 1e-4 where they agree;
     on the card `"binned"` equal to `"bruteforce"` (no tile overflowed);
     b. the gradients with respect to v, vc and albedo, finite, card
     against CPU within 1e-3 of their largest value; c. the 8-view orbit
     batch of the sphere by CUDA events, one frame and its rasterization,
     a profile of one frame (device-busy ms, idle share, device ops), one
     view at `ssaa=2`; d. phase 12's 96³ mesh from the same 8 views: the
     time and the covered-pixel share (not gated).
 14. MVDream text → four views → LGM → splats → gs_to_mesh's supervision
     orbit (`MVDreamPipeline`, `MVDreamConfig()` widths: an SD-1.5 UNet
     with 4-view attention and a camera MLP, the SD VAE; `LGMPipeline`,
     `LGMConfig()`; weights from seed 0 drawn on the card, as the loader
     nodes draw them, so phase 19d's graph has them too; the MVDream_Model
     node's defaults: 30 DDIM steps, CFG 5, elevation 0, seed 0, zero
     prompt embeddings). a. the card against the port's CPU path with TF32
     off at one resnet per block: a UNet call on the CFG batch at the first
     timestep, two guided DDIM steps, the VAE decode of one latent, LGM on
     four 256² views with their Plücker rays and `forward_gaussians`'
     splat fields, each within 1e-3 of its largest value; b. full depth:
     the parameter counts (gated), text → four views by CUDA events
     (warm-up, then 3 runs; TF32 off, then on), peak memory, finite views
     in [0, 1] and their clipped share, one denoise step and the VAE
     decode timed, their FLOPs (`torch.utils.flop_counter`), a profile of
     one step (device-busy ms, the idle share of the profiled window,
     device ops); c. `forward_gaussians` timed, 16,384 finite splats with
     unit quaternions, through GS-PLY and back; d. the 24-view orbit at
     256² on "flat" with the launch counts reset just before and read just
     after (K1′ 24, the others 0), K1′ against its plain version on view 0
     with phase 3's gates, its time and bound there, the per-splat box, the
     share of splats over k = 4 bins (reported), the orbit's time, and text
     → 24 views end to end on the host's clock. The orbit's cameras are
     the converter's (`algorithms/gs_to_mesh.py::orbit_cameras`).
 15. the GS→mesh converter (`algorithms/gs_to_mesh.py::convert` at
     `GSToMeshConfig()`, the Convert_3DGS_to_Mesh node's defaults: 24 views
     at 256², a 384-iteration NeRF fit at `NGPConfig()` widths, a 192³
     grid, σ threshold 10, clean, decimation to 100k faces, the LSCM atlas,
     a 1024² bake). a. the card against the CPU with TF32 off at small
     widths (4 levels of 2^12 entries, 1,024 rays × 32 steps, hidden 16):
     the hash-grid encode and its table gradient, the losses of five fit
     iterations from the same draws, and `density_grid` at 48³ of one
     field, each within 1e-3 (each fit's own parameters, occupancy grid
     and density grid are reported, not gated: float rounding decides the
     fit's discrete turns, the occupancy threshold and Adam's steps near
     its ε, so the tables drift apart while the losses agree);
     `extract_isosurface` of one shared grid (equal faces, vertices within
     1e-5); one shared mesh and atlas rasterized in UV space at 256² (face
     ids agree on ≥ 99.9 % of texels) and baked by `bake_color_fn` (within
     1e-4 where they agree); b. a coloured shell of 20,000 splats of radius
     0.5 (opacity 0.076 each: a wall passes ~30 % of the light, so the fit
     sees the inside) through `convert` with the fit cut to 128 iterations
     (widths kept) and the launch counts reset just before
     and read just after (K1′ 24, the others 0): the fit's loss below 0.5×
     its first, a non-empty mesh of at most 100k faces whose mean vertex
     radius is within 0.1 of 0.5, the albedo finite in [0, 1], the mesh
     through GLB and back, K1′ on view 0 against its plain version (phase
     3's gates) with its time and bound; c. text → phase 14's splats → mesh
     at every default but the NeRF's 128 iterations is phase 19d's graph;
     d. one NeRF step at full width
     (4,096 rays × 128 steps) by CUDA events and profiled: device-busy ms,
     idle share, device ops, the top ops, the hash-grid gather
     (`index_select`) and its scatter (`index_add_`).
 16. Zero123Plus → InstantMesh (config 3: the Zero123Plus_Diffusion_Model and
     InstantMesh_Reconstruction_Model nodes' chain; `Zero123PlusPipeline` at
     `Zero123PlusConfig()`: an SD-2.1 UNet with reference attention on a
     960×640 canvas, the SD VAE; a CLIP vision encoder at `CLIPVisionConfig()`
     widths with projection_dim 1024; ramping coefficients seeded in [0, 1];
     `InstantMeshConfig()`; weights from seed 0; the nodes' defaults: 28
     Euler-ancestral steps, CFG 4, seed 1234, six 320² views at radius 4, fovy
     30). a. the card against the port's CPU path with TF32 off at one resnet
     per block, 2 CLIP layers, a 192×128 canvas and a 128² condition image:
     the CLIP conditioner, `encode_condition`, a UNet write pass and a read
     pass on the CFG batch (the output and every written tensor), two guided
     steps from the same draws, and three loop steps of each of the eight
     samplers from the same noise (KDPM2's with their `aux`), each within 1e-3
     of its largest value; b. full width on a seeded 512² image composited on
     white over a disc mask: the parameter counts (gated), image → grid by
     CUDA events (warm-up, then 2 runs; TF32 off, then on), peak memory, a
     finite grid in [0, 1] and its clipped share, one denoise step (write +
     read pass) timed, its FLOPs, a profile of it (device-busy ms, idle share,
     device ops, top ops, the SDPA kernels that ran), the VAE encode and
     decode and the CLIP encode timed; c. image → grid →
     `split_image_grid(grid, 3, 2)` → the 320² resize → `forward_planes` →
     `extract_mesh` on the host's clock, with the launch counts reset just
     before and read just after (all 0), `forward_planes` timed, one more
     `extract_mesh` split by its spans, the mesh through GLB and back (random
     weights: the face count is reported, not gated).
 17. Hunyuan3D-2.1 shape (config 5's first half: the Hunyuan3D_21_ShapeGen
     node; `Hunyuan3DShapePipeline` at `Hunyuan3DShapeConfig()`:
     DINOv2-giant at 224², the flow DiT of 16 + 32 blocks at width 1,024 on
     3,072 latents, the ShapeVAE of 16 layers; weights from seed 0; the
     node's defaults: seed 1234, 30 steps, CFG 7.5, octree 256, num_chunks
     65,536). a. the parameter counts on `meta` (gated) and the card against
     the port's CPU path with TF32 off at 1 + 2 DiT blocks, 2 DINOv2 layers
     and 1 VAE layer: `encode_cond`, one DiT call on the CFG pair, two guided
     steps from the same noise, the VAE transformer, a dense 17³ decode and
     an 8 → 32 octree decode, each within 1e-3 of its largest value; b.
     the ShapeGen graph of phase 19e (`reference_image(512)` on white over
     its disc as a PNG → the node's background estimate and white
     composite → latents → grid → mesh → the node's cleanup → Save 3D
     Mesh), once on the host's clock split by its nodes', the pipeline's
     and the cleanup's profiler spans (`SHAPE_STAGES`, the decode's levels,
     the extraction's sweep and weld, "hunyuan3d.clean"), the compositor
     kernels' launches counted (all 0), the saved GLB read back equal;
     then, on the loader's weights and the node's processed image, the
     pipeline's stages up to the decoded grid one by one with each stage's
     peak memory (the grid finite and the graph's, within 1e-5 of its
     largest value), 10 steps by CUDA events f32 and TF32, one guided
     step timed, profiled (device-busy ms, idle share, the SDPA kernel) and
     its FLOPs counted, `encode_cond`, the VAE transformer and one decode
     chunk of 65,536 points timed; the mesh through GLB (random weights: the
     triangle counts are reported, not gated); c. the octree decode of an
     analytic sphere at 256 from 64 against the dense 257³ grid on the card:
     equal within 1e-5 where |dense| < 0.04, ≥ 99.9 % of signs where |dense|
     > 0.2, < 0.6 × 257³ queries, the extracted vertices within 0.03 of
     radius 0.5.
 18. Hunyuan3D-2.1 paint (config 5's second half: the
     Load_Hunyuan3D_21_TexGen_Pipeline and Hunyuan3D_21_TexGen nodes;
     `Hunyuan3DPaintPipeline` at `PaintConfig(pbr_settings=("albedo",
     "mr"))`: the 2.5D multi-view UNet and the dual UNet at SD-2.1 widths,
     the SD VAE, six 512² views, 1024² textures; weights from seed 0; the
     nodes' defaults: 8 steps, CFG 3.0, seed 0, the remesh to 40,000 faces)
     on phase 17c's sphere. a. the parameter counts on `meta` (gated) and
     the card against the port's CPU path with TF32 off at one resnet per
     block, 128² views and 256² textures: the dual write pass, the uncond
     and cond passes on 12 rows, one guided step from the same draws, the
     VAE encode and decode, `project_colors` and `bake_projection`, each
     within 1e-3 of its largest value; b. the TexGen graph of phase 19e
     (the sphere as GLB → Load 3D Mesh, phase 19's white-composited PNG →
     LoadImage → the TexGen node with `use_remesh` and `create_pbr` → Save
     3D Mesh) on the host's clock, split by its nodes' and the pipeline's
     profiler spans (`PAINT_STAGES`, `color_project.BAKE_SPANS`), the
     compositor kernels' launches counted (all 0), the textures finite in
     [0, 1] and through GLB (the metallicRoughness texture kept); on the
     loader's weights, the stages once more with each stage's peak memory
     (the bake against the graph's), the 8 steps by CUDA
     events f32 and TF32, one guided step timed, profiled (device-busy ms,
     idle share, the SDPA kernel) and its FLOPs counted, the FLOPs of the
     uncond pass's skipped `attn_refview`, the write pass timed (random
     weights: the textures' statistics are reported, not gated); c. the
     mesh's own position maps baked as the six views: the vertex colours
     and the albedo at the vertices' UVs give back v·0.5 + 0.5 (mean error
     ≤ 0.005, 99th percentile ≤ 0.03) with ≥ 99 % of the vertices seen.
 19. the workflows: configs 1–5 and a 3DGS fit as ComfyUI graphs
     (`config_graph`) through `comfy3d_tpu_torch.nodes.run_workflow(...,
     device="cuda")` at the nodes' defaults and full width, every loader
     drawing its weights on the card (no checkpoint under the nodes'
     root), each graph once under the profiler (`run_graph`; config 4
     and the 3DGS fit between synchronisations, `timed_graph`): its host
     seconds, each node's host and device ms from its `node#<id> <type>`
     span (`timed_graph`: each node's host seconds), peak
     memory and the compositor kernels' launches; every node ran, none
     returned None, every GS_PLY's tensors on the card. a. config
     1: phase 13's UV cube as GLB → the mesh orbit renderer at 512², phase
     4's GS-PLY → the GS orbit renderer at 800², 8 views (equal to
     `render` on the same cameras, ≥ 60 dB; K1′ 8); b. config 2: an RGBA
     PNG → InvertMask → TripoSR → Switch Mesh Axis → Save 3D Mesh with the
     threshold at the 99.9th percentile of σ (the default 25 is far over a
     random-weight field's σ): the saved triangles equal a direct call of
     the loader's model; c. config 3: Load Diffusers Pipeline
     (Zero123Plus) → 28 steps → six views → InstantMesh → Save 3D Mesh; d.
     config 4: MVDream (30 steps) → LGM → Save 3DGS, the GS→mesh converter
     at its defaults but 128 NeRF iterations (of 384) → Save 3D Mesh
     (K1′ 24, the splats against phase
     14's; phase 15c splits the converter's stages); e. config
     5's ShapeGen and TexGen graphs, run as phases 17b and 18b (the linked
     graph is held on the CPU: on the card it would decimate a 14.5 M-
     triangle random-weight surface before painting); f. a 3DGS fit:
     phase 13's sphere → 8 views at 256² → Gaussian Splatting 3D (100
     iterations through `overrides`, batch 1) → its 8 renders (K1′ 108,
     K3′ 100); K1′ and K3′ on the fitted splat from the fit's view 0
     against their plain versions (phases 3 and 5's tolerances). The
     graphs' images and records go to chiprun_out/workflows/.
 20. CRM image → mesh and ImageDream → LGM (the CRM nodes; `MVDreamPipeline`
     at the SD-2.1 ipmv config `load_ldm_checkpoint` builds, 16 IP tokens,
     with a ViT-H/14 penultimate conditioner; `CRMReconPipeline` at
     `CRMConfig()`; weights from seeds drawn on the card). a. the card
     against the port's CPU path with TF32 off at one resnet per block, 2
     ViT-H layers, 2 views (+ the pinned frame) and a 64×192 strip: the
     penultimate states, the IP tokens, the pinned latent, a guided UNet
     call of the pixel stage and of the CCM stage (with its pixel
     latents), the planes and the SDF, deformation and rgb at 32,768
     probes, each within 1e-3 of its largest value; b. the pixel stage
     (six views + the pinned frame, 25 of the nodes' 50 DDIM steps, CFG
     5.5, seed 1234 on a 256² reference composited on white): the
     sampling and one guided step
     by CUDA events, f32 and TF32, the step's FLOPs, a profile of it (idle
     share, SDPA kernel), peak memory, views finite in [0, 1]; c. the CCM
     stage on b's views, the same measures; d. the reconstructor on b's
     views and c's CCMs: the forward (f32, TF32, FLOPs), the 81³ query, the
     extraction and the colours, each timed, the call on the host's clock,
     counts, a GLB round trip, and with `sdfMlp.fc3` zeroed the sphere of
     radius 0.5: its area within 1 % of π, no overflow; e. the CRM graph
     (`config_graph("crm")`, the nodes' defaults but 2 × 20 steps) and the
     T2I V2 graph (10 steps) through `timed_graph` and `run_graph`
     (launches all 0); f.
     ImageDream at the imagedream-ipmv widths (four views + the pinned
     frame, 30 steps, CFG 5) → LGM → the converter's 24-view orbit: K1′ 24,
     on view 0 against its plain version with phase 3's gates, its time
     and bound. It prints a `{"crm": {...}}` line.
 21. Wonder3D and Era3D image → six views + normal maps, fitted into a mesh
     (`Wonder3DPipeline`, `Era3DPipeline` at their default configs with a
     CLIP ViT-L/14 and a ViT-H/14 tower; `algorithms/diff_mesh.py`; weights
     from seeds drawn on the card). a. the card against the port's CPU path
     with TF32 off at one resnet per block, 2 CLIP layers and 64² views:
     each family's conditioning and guided UNet call (Wonder3D at guidance
     1 and 2, Era3D with its pose hook's elevation and focal) and one fit
     step's loss and gradients at 128² (on the pixels whose face ids agree,
     ≥ 99.9 % of them), each within 1e-3 of its largest value; b. Era3D
     (ERA3D_TIMED_STEPS of the node's 40 DDIM steps, CFG 3, seed 600 on a
     512² reference
     composited on white): the sampler by CUDA events in f32, one guided
     step of 24 frames f32 and TF32 with its FLOPs, a profile of it (idle
     share, SDPA kernel), the decode of 12 views, peak memory per stage,
     views and normals finite in [0, 1]; c. Wonder3D (50 steps at
     guidance 1: 12 frames), the same measures, the sampler in TF32 too
     and the step at guidance 2 (24 frames); d. the graph
     `config_graph("era3d_fit")` — LoadImage → Era3D (10 steps) → masks
     from the normals → a UV sphere fitted at the fit node's defaults
     (512² views, batch 3, texture 512) for 136 steps with one remesh after
     128 → Save 3D Mesh — each node timed on the host between
     synchronisations, the segments and the remesh timed, the GLB read
     back, a profiled fit step (device-busy, idle share); e. the analytic
     fit: a textured UV sphere's six Era3D views at 256², fitted from a
     copy scaled by 1.15 with a grey texture for 120 steps: the masked
     render's PSNR must rise by 1 dB, the mean vertex error fall below
     0.95× and the loss fall. It prints an `{"mvdiffusion_fit": {...}}`
     line.
 22. FlexiCubes multi-view depth → mesh (`algorithms/sdf_fit.py`, the
     soft-silhouette kernels `csrc/soft_silhouette.cu`): a. the kernels
     against their plain version on one view of a res-64 training surface
     at 256² (coverage within 1e-5, vertex gradients within 1e-3 of their
     largest value), their times and bounds; b. `config_graph
     ("flexicubes")` — a UV sphere of radius 0.55 → Mesh Orbit Renderer at
     512² on an 8-view orbit → FlexiCubes MVS at its defaults (res 128,
     batch 4, lr 0.01, the normal maps) but FC_ITERS steps and the depths
     decoded over [0, the renders' largest depth] → Save 3D Mesh — each
     node timed between synchronisations; gates: 4 forward and 4 backward
     launches a step, the loss over the 8 views falls, the fitted mesh's
     Chamfer distance to the source below the initial sphere's; the step
     times, a profile of a step (device-busy, idle share), peak memory,
     the extraction and weld seconds, and the kernels against their plain
     version again on the graph's initial surface at 512², their bounds
     counting the live face-pixel pairs only (the walk of every pair
     beside them); c. the first step of `engine="tets"` at 128³, timed,
     its peak. It prints a
     `{"flexicubes": {...}}` line.
 23. TripoSG image / scribble → mesh (`TripoSGConfig()`: DINOv2-L at 518²,
     the 21-block DiT at width 2,048 on 2,048 latents, the VAE decoder of
     16 blocks): a. the parameter counts on `meta` against
     TRIPOSG_PARAMS; b. the card against the port's CPU path with TF32
     off at 3 DiT blocks, 2 decoder blocks and 2 DINOv2 layers: the
     conditioning, a DiT pass, two guided steps, two steps of the
     conditional pass alone, the VAE's decoder, a query and a dense decode
     at 32, each within 1e-3 of its largest value; c. `config_graph
     ("triposg")` at the node's defaults (50 steps, CFG 7, octree 256;
     weights drawn on the card), then a guided step f32 and TF32 with its
     FLOPs, the octree decode's time and peak, and the extraction split
     into sweep and weld; d. `config_graph("triposg_scribble")` (16 steps,
     the conditional pass alone); c. times the loader's pipeline, drawn
     once. It prints a `{"triposg": {...}}` line.
Phases 11–13, 16–18, 20a–e, 21 and 23 launch none of the compositor
kernels, and every phase but 22 none of the silhouette kernels (counted).
It prints a `{"triposr": {...}}`, an `{"instantmesh": {...}}`, a
`{"mesh_render": {...}}`, an `{"mvdream_lgm": {...}}`, a
`{"gs_to_mesh": {...}}`, a `{"zero123plus_instantmesh": {...}}`, a
`{"hunyuan3d_shape": {...}}` and a `{"hunyuan3d_paint": {...}}` line, a
`{"workflows": {...}}` line (each graph's seconds, per-node split, peak
memory and launches), a `{"crm": {...}}` line, an `{"mvdiffusion_fit":
{...}}` line, a `{"flexicubes": {...}}` and a `{"triposg": {...}}` line,
one `{"kernels": [...]}` line (the graphs' counts in `launches_by_path`,
ImageDream → LGM's view 0 in K1′'s `by_path`; the silhouette's forward and
backward, at the graph's shapes, with 22a's in their `by_path`), then
the `nvidia-smi` line, and as its last
line `{"ok": true, "device": {...}}`. With `--out`, the full record
(per-phase errors, times, profile) is also written as JSON to that path.
Without a CUDA device, or without the repository beside this file, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
TOL_ABS = 1e-4          # acc / trans, kernel vs plain
TOL_PSNR_DB = 60.0      # rendered image, kernel vs plain
MAX_STOPS_MISMATCH = 1e-3   # share of bins whose stops may differ
TOL_BWD_REL = 1e-3      # gradient rows, kernel vs plain, / the row's max |plain|
TOL_TILE_FLAT_DB = 40.0  # tile vs coarse-bin render on the 20k/256² scene
LOSS_DROP = 0.7         # trainer learns: last-10 mean loss < 0.7 × first-10
DEAD_SLOTS = 1024       # dead slots after the full-width splat's 100k
# the learning check's render size: at 128² the initial splats' 3σ boxes
# span more than the k = 4 coarse bins a splat may occupy
# (`max_tiles_per_prim` 16, as in the JAX package) and are cut off
LEARN_SIZE = 64


def log(msg):
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def count_params(module):
    return sum(p.numel() for p in module.parameters())


def tf32_ms(fn, iters, warmup=1):
    """`cuda_ms` with TF32 on for matmuls and convolutions, then off."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        return cuda_ms(fn, iters, warmup=warmup)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def profile_frames(fn, frames, rows=None, match=()):
    """torch.profiler over `frames` calls of fn: device-busy ms per frame
    (the sum of the device ops' times, and `device_union_ms`, the time at
    least one ran: they differ where ops run concurrently), the profiled
    window's ms per frame on the host's clock, device-side ops per frame,
    and the ops with the most device time; the device time and launches of
    PyTorch's `index_add_` kernels, and the device time and calls of its
    `index_select` ops. With
    `rows` (a shape [n, D]), also the row gathers per frame: the indexing
    ops (`aten::index`, `index_select`, `gather`, `take`) whose source has
    that shape, i.e. a gather of the per-splat rows a forward kernel reads
    by index. With `match` (substrings), also the device ops whose names
    hold one of them, in lower case (`matched`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=rows is not None) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # device-side entries only (kernels, copies, memsets): a host op's
    # entry repeats the device time of the kernels it launched
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    ops.sort(key=dev_us, reverse=True)
    # PyTorch's index_add_ kernels (indexFuncLargeIndex / SmallIndex), and
    # the device time of its index_select ops (a gather kernel on the card)
    scatter = [e for e in ops if "indexFunc" in e.key]
    gather = [e for e in prof.key_averages()
              if e.key == "aten::index_select"
              and e.device_type == DeviceType.CPU]
    out = dict(
        device_busy_ms=sum(dev_us(e) for e in ops) / 1e3 / frames,
        device_ops=sum(e.count for e in ops) / frames,
        index_add_ms=sum(dev_us(e) for e in scatter) / 1e3 / frames,
        index_add_launches=sum(e.count for e in scatter) / frames,
        index_select_ms=sum(getattr(e, "device_time_total", 0)
                            for e in gather) / 1e3 / frames,
        index_select_calls=sum(e.count for e in gather) / frames,
        top=[dict(name=e.key[:80], ms=dev_us(e) / 1e3 / frames,
                  count=e.count / frames) for e in ops[:10]],
        window_ms=window_s * 1e3 / frames)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out["device_union_ms"] = _union_ms([e.time_range for e in kernels]) \
        / frames
    if match:
        out["matched"] = [
            dict(name=e.key[:80], ms=dev_us(e) / 1e3 / frames,
                 count=e.count / frames) for e in ops
            if any(m in e.key.lower() for m in match)]
    out["device_streams"] = sorted({e.device_resource_id for e in kernels})
    out["overlaps"] = _overlaps(kernels, frames)
    if rows is not None:
        names = ("aten::index", "aten::index_select", "aten::gather",
                 "aten::take")
        hits = [e for e in prof.key_averages(group_by_input_shape=True)
                if e.key in names and e.input_shapes
                and list(e.input_shapes[0]) == list(rows)]
        out["row_gathers"] = sum(e.count for e in hits) / frames
        out["row_gather_ops"] = [
            dict(name=e.key, input_shapes=str(e.input_shapes)[:160],
                 count=e.count / frames) for e in hits]
    return out


def _union_ms(ranges):
    """The length of the union of profiler time ranges (µs) in ms: the
    time at least one device op ran."""
    total, end = 0.0, -math.inf
    for r in sorted(ranges, key=lambda r: r.start):
        if r.end > end:
            total += r.end - max(r.start, end)
            end = r.end
    return total / 1e3


def _overlaps(kernels, frames, top=4):
    """Device ops that ran while an earlier one had not ended: per pair of
    (earlier op, stream; later op, stream), the overlapped ms and count per
    frame, the largest first."""
    pairs, last = {}, None
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        if last is not None and e.time_range.start < last.time_range.end:
            key = (last.name[:60], last.device_resource_id, e.name[:60],
                   e.device_resource_id)
            ms, n = pairs.get(key, (0.0, 0))
            pairs[key] = (ms + (min(e.time_range.end, last.time_range.end)
                                - e.time_range.start) / 1e3, n + 1)
        if last is None or e.time_range.end > last.time_range.end:
            last = e
    return [dict(first=a, first_stream=sa, second=b, second_stream=sb,
                 ms=ms / frames, count=n / frames)
            for (a, sa, b, sb), (ms, n) in sorted(
                pairs.items(), key=lambda kv: -kv[1][0])[:top]]


def smi(fields):
    """One line of `nvidia-smi --query-gpu=<fields>` for card 0."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def subtiles_in_image(inp):
    """[nbins, 4] bool: the 16-px sub-tiles whose origin lies in the
    image."""
    import torch
    from comfy3d_tpu_torch.ops.gs_flat import TILE
    t = torch.arange(inp["nbx"] * inp["nby"],
                     device=inp["data"].device)[:, None]
    s = torch.arange(4, device=t.device)[None, :]
    ox = ((t % inp["nbx"]) * 2 + s % 2) * TILE
    oy = (torch.div(t, inp["nbx"], rounding_mode="floor") * 2
          + torch.div(s, 2, rounding_mode="floor")) * TILE
    return (ox < inp["W"]) & (oy < inp["H"])


def psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def make_splat(n, scale, seed, device):
    """bench.py's scene: n random splats in a 0.8 ball, SH degree 0, scale
    `scale`, opacity_raw 1.0 (random weights from a seed)."""
    import dataclasses
    import torch
    from comfy3d_tpu_torch.core.gaussian import GaussianSplat
    s = GaussianSplat.random(torch.Generator().manual_seed(seed), n,
                             sh_degree=0, radius=0.8, device=device)
    return dataclasses.replace(
        s, scale_raw=torch.full_like(s.scale_raw, math.log(scale)),
        opacity_raw=torch.full_like(s.opacity_raw, 1.0))


def flat_inputs(splat, cam, bin_px=32):
    """The compositor's inputs for one camera, as `render_arrays` builds
    them: projection, SH colour, coarse sort, the per-splat rows the kernel
    reads by index; and the gathered payload its plain version takes."""
    import torch
    from comfy3d_tpu_torch.ops import binning, gs_flat
    from comfy3d_tpu_torch.ops import gs_render as G
    W, H = cam.width, cam.height
    means2d, depth, conic, radii, visible = G.project_gaussians(
        splat.xyz, splat.scale, splat.rotation, cam.w2c, cam.intrinsics,
        W, H)
    active = visible & splat.alive & (splat.opacity > G.ALPHA_MIN)
    chans = torch.cat([splat.colors_toward(cam.campos), depth[:, None]], -1)
    nby, nbx = binning.num_bins(H, W, bin_px)
    k = G.max_tiles_per_prim_coarse(16)
    sprim, bounds, _ = binning.bin_coarse(means2d, depth, radii, active,
                                          nby, nbx, k=k, bin_px=bin_px)
    r_row = torch.where(active, torch.clamp_min(radii, 0.5),
                        torch.zeros_like(radii))
    pack_args = (means2d, conic, splat.opacity, chans, r_row)
    rows = G.payload_rows(*pack_args)
    data = gs_flat.gather_payload(rows, sprim)
    sort_args = (means2d, depth, radii, active, nby, nbx, k)
    return dict(data=data, rows=rows, bounds=bounds, nbx=nbx, nby=nby, W=W,
                H=H, C=chans.shape[-1], sort_args=sort_args, sprim=sprim,
                n=means2d.shape[0], bin_px=bin_px, pack_args=pack_args)


def flat_gather(inp):
    """The payload gather K1′ took in (once the forward's input, now the
    backward's): the rows packed and gathered in pair order."""
    from comfy3d_tpu_torch.ops import gs_flat
    from comfy3d_tpu_torch.ops import gs_render as G
    return gs_flat.gather_payload(G.payload_rows(*inp["pack_args"]),
                                  inp["sprim"])


def flat_kernel_args(inp, merged):
    """K1′'s arguments (`composite_bins_fwd_rows`) for this input, and its
    plain version's on the gathered payload (`composite_bins_fwd_plain`)."""
    geo = (inp["bounds"], inp["nbx"], inp["nby"], inp["C"], inp["W"],
           inp["H"], inp["bin_px"], merged)
    return (inp["rows"], inp["sprim"], *geo), (inp["data"], *geo)


def to_image(acc, trans, inp):
    from comfy3d_tpu_torch.ops import gs_render as G
    geo = (inp["nby"], inp["nbx"], inp["H"], inp["W"], inp["bin_px"])
    img = G._bins_to_image(acc, *geo)
    tr = G._bins_to_image(trans, *geo)
    return img[..., :-1] + tr * 1.0         # rgb + (1 - alpha) · white


def visits(inp, stops):
    """Pair-pixel visits this input makes up to `stops`: pairs of the
    composited chunks whose 3σ square meets a sub-tile, × 256 pixels."""
    import torch
    from comfy3d_tpu_torch.ops.gs_flat import CHUNK, TILE
    data, bounds = inp["data"], inp["bounds"].long()
    nbins = inp["nbx"] * inp["nby"]
    counts = bounds[1:] - bounds[:-1]
    g = torch.arange(int(bounds[-1]), device=data.device)
    t = torch.repeat_interleave(torch.arange(nbins, device=data.device),
                                counts)
    q = torch.div(g - torch.div(bounds[:-1], CHUNK, rounding_mode="floor")
                  [t] * CHUNK, CHUNK, rounding_mode="floor")
    bx = (t % inp["nbx"]) * 2 * TILE
    by = torch.div(t, inp["nbx"], rounding_mode="floor") * 2 * TILE
    mxl, myl = data[0, :g.numel()] - bx, data[1, :g.numel()] - by
    r = data[6 + inp["C"], :g.numel()]
    total = 0
    for s in range(4):
        sx0, sy0 = (s % 2) * TILE, (s // 2) * TILE
        ov = ((mxl + r > sx0) & (mxl - r < sx0 + TILE)
              & (myl + r > sy0) & (myl - r < sy0 + TILE))
        total += int((ov & (q < stops[t, s].long())).sum())
    return total * TILE * TILE


def kernel_vs_plain(label, inp, merged):
    """K1′ (merged) or K2′ against its plain version on the gathered
    payload: stops, acc/trans max abs error, the image's PSNR."""
    import torch
    from comfy3d_tpu_torch.ops import gs_flat
    args, plain_args = flat_kernel_args(inp, merged)
    acc, tr, st = gs_flat.composite_bins_fwd_rows(*args)
    torch.cuda.synchronize()
    p_acc, p_tr, p_st = gs_flat.composite_bins_fwd_plain(*plain_args)
    bad = (st != p_st).any(-1)
    n_bad = int(bad.sum())
    if n_bad:
        log(f"{label}: stops differ in bins {bad.nonzero()[:, 0].tolist()}")
    check(n_bad <= MAX_STOPS_MISMATCH * bad.numel(),
          f"{label}: stops differ in {n_bad} of {bad.numel()} bins")
    keep = ~bad
    err_acc = float((acc - p_acc).abs()[keep].max())
    err_tr = float((tr - p_tr).abs()[keep].max())
    db = psnr(to_image(acc, tr, inp), to_image(p_acc, p_tr, inp))
    rec = dict(max_abs_err_acc=err_acc, max_abs_err_trans=err_tr,
               stops_mismatch_bins=n_bad, psnr_db=db,
               pairs=int(inp["bounds"][-1]), bin_px=inp["bin_px"],
               max_stop=int(st.max()))
    log(f"{label}: {rec}")
    check(err_acc <= TOL_ABS and err_tr <= TOL_ABS,
          f"{label}: acc err {err_acc}, trans err {err_tr} > {TOL_ABS}")
    check(db >= TOL_PSNR_DB, f"{label}: PSNR {db:.2f} dB < {TOL_PSNR_DB}")
    return rec, (acc, tr, st), to_image(p_acc, p_tr, inp)


def pair_bins(inp):
    """Per pair column g < pairs: its bin t and its chunk q within the bin's
    aligned walk."""
    import torch
    from comfy3d_tpu_torch.ops.gs_flat import CHUNK
    bounds = inp["bounds"].long()
    dev = bounds.device
    nbins = inp["nbx"] * inp["nby"]
    g = torch.arange(int(bounds[-1]), device=dev)
    t = torch.repeat_interleave(torch.arange(nbins, device=dev),
                                bounds[1:] - bounds[:-1])
    q = torch.div(g - torch.div(bounds[:-1], CHUNK, rounding_mode="floor")
                  [t] * CHUNK, CHUNK, rounding_mode="floor")
    return g, t, q


def walked_subtiles(inp, stops, t, q):
    """[pairs, 4] bool: in-image sub-tiles whose composited prefix holds the
    pair's chunk (what the backward walks)."""
    return subtiles_in_image(inp)[t] & (q[:, None] < stops[t].long())


def bwd_visits(inp, stops, block=16384):
    """The backward's pair-pixel visits on this input: footprint (walked
    sub-tiles the pair's 3σ square meets), live (of those the pixels with
    op·G ≥ 1/255), unsat (of those the ones with op·G < 0.99), evaluated
    with the kernel's operations; and two counts of the per-slot
    one-CTA-per-bin design: pair_warps_live, its warp reductions (walked
    pairs × the 8 warps of 32 pixel slots, each over the 4 sub-tiles, with
    a live lane), and pairs_walked (pairs with a footprint bit in a walked
    sub-tile); pair_subtiles (walked (pair, sub-tile) footprint entries)."""
    import torch
    from comfy3d_tpu_torch.ops.gs_flat import ALPHA_MAX, ALPHA_MIN, TILE
    data, C = inp["data"], inp["C"]
    g, t, q = pair_bins(inp)
    walk = walked_subtiles(inp, stops, t, q)
    p = torch.arange(TILE * TILE, device=data.device)
    s = torch.arange(4, device=data.device)
    sx0 = ((s % 2) * TILE).float()
    sy0 = (torch.div(s, 2, rounding_mode="floor") * TILE).float()
    px = (p % TILE).float()[None, :] + (sx0[:, None] + 0.5)
    py = torch.div(p, TILE, rounding_mode="floor").float()[None, :] \
        + (sy0[:, None] + 0.5)
    fp = live = unsat = warps_live = pairs_walked = 0
    for lo in range(0, g.numel(), block):
        sl = slice(lo, min(lo + block, g.numel()))
        tt = t[sl]
        mxl = data[0, sl] - ((tt % inp["nbx"]) * 2 * TILE).float()
        myl = data[1, sl] - (torch.div(tt, inp["nbx"], rounding_mode="floor")
                             * 2 * TILE).float()
        r = data[6 + C, sl]
        ov = walk[sl] & ((mxl[:, None] + r[:, None] > sx0)
                         & (mxl[:, None] - r[:, None] < sx0 + TILE)
                         & (myl[:, None] + r[:, None] > sy0)
                         & (myl[:, None] - r[:, None] < sy0 + TILE))
        e = (slice(None), None, None)
        dx = px - mxl[e]
        dy = py - myl[e]
        a, b, c, op = (data[i, sl][e] for i in (2, 3, 4, 5))
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        raw = op * torch.exp(torch.clamp_max(power, 0.0))
        hit = ov[..., None] & (raw >= ALPHA_MIN)          # [b, 4, 256]
        fp += int(ov.sum()) * TILE * TILE
        live += int(hit.sum())
        unsat += int((hit & (raw < ALPHA_MAX)).sum())
        warps_live += int(hit.reshape(hit.shape[0], 4, 8, 32).any(-1)
                          .any(1).sum())
        pairs_walked += int(ov.any(-1).sum())
    return dict(footprint_visits=fp, live_visits=live, unsat_visits=unsat,
                pair_warps_live=warps_live, pairs_walked=pairs_walked,
                pair_subtiles=fp // (TILE * TILE))


def bwd_bound(inp, stops):
    """The least time of K3's function, the coarse-bin backward with its
    per-splat scatter, on this input: bytes (payload rows, trans, g_acc,
    g_trans, stops, bounds and the pairs' splat indices read, the [n, 6 + C]
    per-splat rows written, each once) against f32 operations counted from
    the kernel's arithmetic per visit: 15 per footprint visit (offsets,
    power, exp, raw, test), 12 + 4C more per live one (alpha, log, log T_i,
    exp, chan·g, α·T_i, d chan, S), 33 more per unsaturated one (dα, d op,
    d power, d μ, d conic), and 6 + C adds per walked (pair, sub-tile)."""
    C = inp["C"]
    nbins = inp["nbx"] * inp["nby"]
    pairs = int(inp["bounds"][-1])
    pix = nbins * 4 * 256
    in_bytes = ((7 + C) * pairs + (C + 2) * pix + nbins * 4 + nbins + 1) * 4 \
        + pairs * 8
    out_bytes = inp["n"] * (6 + C) * 4
    v = bwd_visits(inp, stops)
    ops = 15 * v["footprint_visits"] + (12 + 4 * C) * v["live_visits"] \
        + 33 * v["unsat_visits"] + (6 + C) * v["pair_subtiles"]
    return _bound(in_bytes, out_bytes, ops, **v)


def bwd_args(inp, fwd, seed):
    """K3's arguments (`composite_bins_bwd_splats`) for a forward kernel's
    (acc, trans, stops), with cotangents drawn from a seeded generator on
    the card; and the per-pair plain function's
    (`composite_bins_bwd_plain`) for the same inputs."""
    import torch
    acc, trans, stops = fwd
    gen = torch.Generator(device=acc.device).manual_seed(seed)
    g_acc = torch.randn(acc.shape, generator=gen, device=acc.device)
    g_trans = torch.randn(trans.shape, generator=gen, device=acc.device)
    geo = (inp["nbx"], inp["nby"], inp["C"], inp["W"], inp["H"])
    return ((inp["data"], inp["bounds"], inp["sprim"], inp["n"], trans,
             stops, g_acc, g_trans, *geo),
            (inp["data"], inp["bounds"], trans, stops, g_acc, g_trans, *geo))


def walked_pair_rows(inp, stops, cols):
    """The per-pair plain columns [DG, P] of the pairs some in-image
    sub-tile walked, as rows [S, 6 + C], and their splats [S]."""
    g, t, q = pair_bins(inp)
    g = g[walked_subtiles(inp, stops, t, q).any(-1)]
    return cols[:6 + inp["C"], g].t(), inp["sprim"][g]


def walked_slot_rows(inp, cols):
    """The per-slot plain columns [T, D, M] of the valid slots below each
    tile's count, as rows [S, 6 + C], and their splats [S]."""
    import torch
    m = cols.shape[2]
    walked = inp["valid"] & (torch.arange(m, device=cols.device)[None, :]
                             < inp["counts"][:, None])
    return (cols.transpose(1, 2)[walked][:, :6 + inp["C"]],
            inp["prim_idx"][walked])


def splat_rows_vs_plain(label, k, p, rows, idx):
    """A backward kernel's per-splat rows k [n, 6 + C] against its plain
    version's p: per gradient row max |k − p| / max |p|; the rows of splats
    that no walked slot holds (none of `idx`) exactly 0 in both; splat 0's
    row against the sum of its own walked slots' plain `rows`, per row
    relative to that row's max |p|."""
    import torch
    nrow = k.shape[1]
    scale = p.abs().amax(0).clamp_min(1e-30)
    rel = (((k - p).abs().amax(0)) / scale).tolist()
    worst = max(range(nrow), key=lambda r: rel[r])
    held = torch.zeros(k.shape[0], dtype=torch.bool, device=k.device)
    held[idx] = True
    untouched_zero = not bool(k[~held].any()) and not bool(p[~held].any())
    own = rows[idx == 0].sum(0)
    row0_rel = float(((k[0] - own).abs() / scale).max())
    rec = dict(max_rel_err=rel[worst], worst_row=worst, rel_err_rows=rel,
               max_abs_err=float((k - p).abs().max()),
               splats_held=int(held.sum()), untouched_zero=untouched_zero,
               splat0_slots=int((idx == 0).sum()), splat0_rel_err=row0_rel)
    log(f"bwd {label}: worst row {worst} rel err {rel[worst]:.3g}, max abs "
        f"err {rec['max_abs_err']:.3g}, {rec['splats_held']} splats held, "
        f"untouched zero {untouched_zero}, splat 0 ({rec['splat0_slots']} "
        f"slots) rel err {row0_rel:.3g}")
    check(bool(torch.isfinite(k).all()), f"bwd {label}: non-finite")
    check(rel[worst] <= TOL_BWD_REL,
          f"bwd {label}: row {worst} rel err {rel[worst]} > {TOL_BWD_REL}")
    check(untouched_zero, f"bwd {label}: rows of untouched splats are not 0")
    check(row0_rel <= TOL_BWD_REL, f"bwd {label}: splat 0's row is not the "
          f"sum of its slots (rel err {row0_rel})")
    return rec


def bwd_vs_plain(label, inp, fwd, seed):
    """K3 against its plain version (`splat_rows_vs_plain`)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_flat
    args, pair_args = bwd_args(inp, fwd, seed)
    k = gs_flat.composite_bins_bwd_splats(*args)
    torch.cuda.synchronize()
    p = gs_flat.composite_bins_bwd_splats_plain(*args)
    rows, idx = walked_pair_rows(
        inp, fwd[2], gs_flat.composite_bins_bwd_plain(*pair_args))
    return splat_rows_vs_plain(label, k, p, rows, idx)


def pipe_on(pipe, device):
    """A pipeline drawn on the CPU, on `device`: `pipe` itself on the CPU,
    else a pipeline around a copy of its model. One seed draws different
    weights from the CPU's and the card's generators, so a card-vs-CPU
    check draws once, on the CPU."""
    if device.type == "cpu":
        return pipe
    return type(pipe)(copy.deepcopy(pipe.model).to(device))


def synthetic_views(dev, size, n_views=4):
    """tests/test_gs_trainer.py's scene: 4 coloured splats rendered by the
    port from an orbit at elevation 0 → (cameras, images, alpha masks)."""
    import dataclasses
    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.gaussian import GaussianSplat
    from comfy3d_tpu_torch.ops import gs_render as G
    gt = GaussianSplat.from_points(
        np.array([[0.0, 0, 0], [0.25, 0, 0], [0, 0.25, 0], [0, 0, 0.25]],
                 np.float32),
        colors=np.array([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1],
                         [0.1, 0.1, 0.9], [0.9, 0.9, 0.1]], np.float32),
        initial_scale=0.12, device=dev)
    gt = dataclasses.replace(gt, opacity_raw=torch.full_like(
        gt.opacity_raw, 3.0))
    cams = Camera.from_orbit([0.0] * n_views,
                             [i * 360.0 / n_views for i in range(n_views)],
                             2.0, width=size, height=size, device=dev)
    out = G.render(gt, cams, background=(1.0, 1.0, 1.0))
    return cams, out["image"], out["alpha"]


def trainer_learns(dev, backend="flat"):
    """Phase 6 (and 10, with backend "tile"): 64 random splats fitted to
    the synthetic views."""
    import torch
    from comfy3d_tpu_torch.algorithms import gs_trainer as T
    from comfy3d_tpu_torch.core.gaussian import GaussianSplat
    from comfy3d_tpu_torch.ops import gs_render as G
    cams, imgs, masks = synthetic_views(dev, LEARN_SIZE)
    init = GaussianSplat.random(torch.Generator().manual_seed(1), 64,
                                radius=0.4, device=dev)
    check(not bool(G.render(init, cams, backend=backend)["overflow"].any()),
          f"initial splats overflow their {backend} lists at {LEARN_SIZE}²")
    cfg = T.GSTrainConfig(iterations=120, batch_size=2,
                          density_start_iter=10_000,
                          position_lr_init=0.002, position_lr_final=0.0002,
                          backend=backend)
    step = T.make_train_step(cfg, cams, imgs, masks)
    state = T.init_state(init)
    gen = torch.Generator().manual_seed(2)
    losses = []
    t0 = time.perf_counter()
    for _ in range(cfg.iterations):
        state, m = step(state, *T.draw_step_inputs(gen, 4, 2, 0.5))
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    rec = dict(backend=backend, steps=cfg.iterations, size=LEARN_SIZE,
               first10=first, last10=last,
               ratio=last / first, seconds=time.perf_counter() - t0)
    log(f"trainer learns ({backend}): {rec}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(last < LOSS_DROP * first,
          f"loss {first:.4f} → {last:.4f}, not below {LOSS_DROP}×")
    return rec


def pad_dead(splat, extra):
    """The splat with `extra` dead slots appended (zeros, unit rotation)."""
    import dataclasses
    import torch

    def pad(x):
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

    rot = pad(splat.rot_raw)
    rot[-extra:, 0] = 1.0
    return dataclasses.replace(
        splat, xyz=pad(splat.xyz), sh=pad(splat.sh),
        opacity_raw=pad(splat.opacity_raw), scale_raw=pad(splat.scale_raw),
        rot_raw=rot, alive=pad(splat.alive))


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from comfy3d_tpu_torch.ops import gs_flat, gs_tile, rasterize
    for fn in (gs_flat.composite_bins_fwd_rows,
               gs_flat.composite_bins_bwd_splats,
               gs_tile.composite_tiles_fwd_rows,
               gs_tile.composite_tiles_bwd_splats,
               rasterize.soft_silhouette_fwd, rasterize.soft_silhouette_bwd):
        fn.launches = 0


def read_launches():
    from comfy3d_tpu_torch.ops import gs_flat, gs_tile, rasterize
    return {"gs_flat_fwd": gs_flat.composite_bins_fwd_rows.launches,
            "gs_flat_bwd": gs_flat.composite_bins_bwd_splats.launches,
            "gs_tile_fwd": gs_tile.composite_tiles_fwd_rows.launches,
            "gs_tile_bwd": gs_tile.composite_tiles_bwd_splats.launches,
            "soft_silhouette_fwd": rasterize.soft_silhouette_fwd.launches,
            "soft_silhouette_bwd": rasterize.soft_silhouette_bwd.launches}


def expect_launches(launches, backend, fwd, bwd, what):
    want = {k: 0 for k in launches}
    want[f"gs_{backend}_fwd"] = fwd
    want[f"gs_{backend}_bwd"] = bwd
    check(launches == want, f"{what}: launches {launches}, not {want}")


def train_full_width(dev, asset_dir, backend="flat", size=800, n=100_000,
                     n_views=4, clock_mhz=1980.0):
    """Phase 7 (and 10, with backend "tile"): bench.py's gs_train_step
    set-up on the card."""
    import numpy as np
    import torch
    from comfy3d_tpu_torch.algorithms import gs_trainer as T
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.io.ply import load_gs_ply, save_gs_ply
    from comfy3d_tpu_torch.ops import gs_flat, gs_tile
    splat = pad_dead(make_splat(n, 0.01, 5, dev), DEAD_SLOTS)
    cams = Camera.from_orbit([0.0] * n_views, [0.0, 90.0, 180.0, 270.0],
                             2.2, width=size, height=size, device=dev)
    imgs = torch.as_tensor(np.random.RandomState(7).rand(
        n_views, size, size, 3).astype(np.float32), device=dev)
    masks = torch.ones((n_views, size, size), device=dev)
    cfg = T.GSTrainConfig(batch_size=1, backend=backend)
    step = T.make_train_step(cfg, cams, imgs, masks)
    holder = {"state": T.init_state(splat)}
    dead = ~splat.alive
    dead_before = {k: v[dead].clone() for k, v in
                   holder["state"].params.items()}
    gen = torch.Generator().manual_seed(3)

    def one_step():
        holder["state"], m = step(holder["state"],
                                  *T.draw_step_inputs(gen, n_views, 1, 0.5))
        return m

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = [one_step()["loss"] for _ in range(10)]
    torch.cuda.synchronize()
    first10_s = time.perf_counter() - t0
    launches = read_launches()
    losses = torch.stack(losses).tolist()
    log(f"train path ({backend}): 10 steps at {size}²/{n} in "
        f"{first10_s * 1e3:.0f} ms (first calls), launches {launches}, "
        f"losses {losses}")
    expect_launches(launches, backend, 10, 10, f"10 {backend} train steps")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    state = holder["state"]
    check(all(torch.equal(state.params[k][dead], dead_before[k])
              for k in dead_before), "dead slots changed")

    times = {"train_step_ms": cuda_ms(one_step, 10)}
    width = gs_tile.rows_width(4) if backend == "tile" \
        else gs_flat.payload_width(4)      # SH colour (3) and depth
    prof = profile_frames(one_step, 3, rows=(splat.num_capacity, width))
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] \
        / times["train_step_ms"]
    log(f"train step ({backend}) {times['train_step_ms']:.2f} ms; profile "
        f"{prof}")
    check(prof["index_add_launches"] == 0, f"the {backend} train step still "
          f"scatters with index_add_ ({prof['index_add_ms']:.3f} ms)")
    # the tile step's forward writes the backward's block itself; the flat
    # step gathers the payload once, for its backward
    check(prof["row_gathers"] == (0 if backend == "tile" else 1),
          f"the {backend} train step's row gathers: "
          f"{prof['row_gather_ops']}")

    # the backward kernel alone, on the trained splat's compositor inputs
    # for view 0; its launches here are not the path's
    cam0 = Camera.from_orbit(0.0, 0.0, 2.2, width=size, height=size,
                             device=dev)
    trained = holder["state"].to_splat()
    if backend == "flat":
        inp = flat_inputs(trained, cam0)
        fargs, _ = flat_kernel_args(inp, True)
        fwd = gs_flat.composite_bins_fwd_rows(*fargs)
        times["kernel_fwd_ms"] = cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows(*fargs), 20)
        box = flat_box_stats(inp, fwd[2])
        fwd_bound = flat_fwd_bound(inp, fwd[2], box)
        args, pair_args = bwd_args(inp, fwd, 11)
        kernel, plain = gs_flat.composite_bins_bwd_splats, \
            gs_flat.composite_bins_bwd_splats_plain
        bound = bwd_bound(inp, fwd[2])
        in_img = subtiles_in_image(inp)
        stops = torch.where(in_img, fwd[2], torch.zeros_like(fwd[2]))
        old = old_design(bound["pair_warps_live"], inp["C"],
                         stops.amax(-1), clock_mhz)
        new_walks = stops[in_img].float()
        cols = gs_flat.composite_bins_bwd_plain(*pair_args)
        rows, idx = cols[:, :inp["sprim"].numel()].t(), inp["sprim"]
    else:
        inp = tile_inputs(trained, cam0, cfg.max_per_tile)
        fwd = gs_tile.composite_tiles_fwd_rows(*tile_kernel_args(inp, True))
        times["kernel_fwd_ms"] = cuda_ms(
            lambda: gs_tile.composite_tiles_fwd_rows(
                *tile_kernel_args(inp, True)), 20)
        box = tile_box_stats(inp)
        fwd_bound = tile_fwd_bound(inp, box, keep_block=True)
        args, slot_args = tile_bwd_args(inp, fwd, 11)
        kernel, plain = gs_tile.composite_tiles_bwd_splats, \
            gs_tile.composite_tiles_bwd_splats_plain
        bound = tile_bwd_bound(inp)
        walks = torch.div(inp["counts"] + 127, 128, rounding_mode="floor")
        old = old_design(bound["slot_warps_live"], inp["C"], walks,
                         clock_mhz)
        new_walks = walks.float()
        cols = gs_tile.composite_tiles_bwd_plain(*slot_args)
        rows = cols.transpose(1, 2).reshape(-1, cols.shape[1])
        idx = inp["prim_idx"].reshape(-1)
    log(f"{backend} train view 0, forward kernel "
        f"{times['kernel_fwd_ms']:.4f} ms, bound {fwd_bound}, per-splat box "
        f"{box}")
    check_box(box, f"{backend} train view 0")
    old.update(new_walk_chunks_max=int(new_walks.max()),
               new_walk_chunks_mean=float(new_walks.mean()),
               new_ctas=new_walks.numel())
    times["kernel_bwd_ms"] = cuda_ms(lambda: kernel(*args), 20)
    times["plain_bwd_ms"] = cuda_ms(lambda: plain(*args), 3, warmup=1)
    # the old design's per-step scatter, on the plain per-slot columns
    times["old_scatter_ms"] = cuda_ms(
        lambda: scatter_columns(rows, idx, inp["n"], inp["C"]), 20)
    old["scatter_device_ms"] = profile_frames(
        lambda: scatter_columns(rows, idx, inp["n"], inp["C"]),
        3)["device_busy_ms"]
    log(f"{'K3' if backend == 'flat' else 'K5'} at {size}²/{n}: kernel "
        f"{times['kernel_bwd_ms']:.3f} ms, plain "
        f"{times['plain_bwd_ms']:.1f} ms, old scatter "
        f"{times['old_scatter_ms']:.3f} ms, bound {bound}, old design {old}")
    del cols, rows

    # densify and prune, opacity reset, GS-PLY round trip
    cap = splat.num_capacity
    noise = torch.randn((2, cap, 3), generator=gen).to(dev)
    state = T.make_densify_step(cfg)(holder["state"], noise[0], noise[1])
    state = T.reset_opacity(state)
    check(state.alive.shape[0] == cap and all(
        v.shape[0] == cap for v in state.params.values()),
        "capacity changed")
    check(all(bool(torch.isfinite(v).all()) for v in state.params.values()),
          "non-finite parameters after densify / reset")
    check(float(torch.sigmoid(state.params["opacity_raw"]).max()) <= 0.0101,
          "opacity reset left an opacity above 0.01")
    path = os.path.join(asset_dir, f"trained_100k_{backend}.ply")
    trained = state.to_splat()
    save_gs_ply(path, trained)
    back = load_gs_ply(path, device=dev)
    check(torch.equal(back.xyz, trained.xyz[trained.alive]),
          "trained splat changed through GS-PLY")
    rec = dict(backend=backend, splats=n, dead_slots=DEAD_SLOTS, size=size,
               views=n_views, batch=1, max_per_tile=cfg.max_per_tile,
               launches=launches, losses=losses,
               first_10_steps_s=first10_s,
               alive_after_densify=int(state.alive.sum()),
               ply_splats=back.num_capacity, old_design=old, box=box,
               fwd_bound=fwd_bound)
    return rec, times, prof, bound


# ------------------------------------------------------------------ #
# The per-16-px-tile compositor (phases 8-10)
# ------------------------------------------------------------------ #
def tile_inputs(splat, cam, max_per_tile):
    """The tile compositor's inputs for one camera, as `render_tiles` builds
    them: projection, SH colour, depth order, binning, tile-data gather."""
    import torch
    from comfy3d_tpu_torch.ops import binning
    from comfy3d_tpu_torch.ops import gs_render as G
    W, H = cam.width, cam.height
    means2d, depth, conic, radii, visible = G.project_gaussians(
        splat.xyz, splat.scale, splat.rotation, cam.w2c, cam.intrinsics,
        W, H)
    active = visible & splat.alive & (splat.opacity > G.ALPHA_MIN)
    chans = torch.cat([splat.colors_toward(cam.campos), depth[:, None]], -1)
    grid_h, grid_w = binning.num_tiles(H, W)
    order = torch.argsort(torch.where(active, depth, math.inf), stable=True)
    s_m2d, s_r = means2d[order], radii[order][:, None]
    bin_args = (s_m2d - s_r, s_m2d + s_r, active[order], grid_h, grid_w,
                max_per_tile)
    bins = binning.bin_primitives(*bin_args)
    gather_args = (s_m2d, conic[order], splat.opacity[order], chans[order],
                   bins.prim_idx, bins.valid)
    rows = G.tile_rows(*gather_args[:4])
    data = G._build_tile_data(*gather_args)
    return dict(data=data, rows=rows,
                counts=torch.clamp_max(bins.count, max_per_tile),
                prim_idx=bins.prim_idx, valid=bins.valid, n=means2d.shape[0],
                grid_w=grid_w, grid_h=grid_h, W=W, H=H, C=chans.shape[-1],
                overflow=bool(bins.overflow), bin_args=bin_args,
                gather_args=gather_args)


def tile_kernel_args(inp, keep_block):
    """K4′'s arguments (`composite_tiles_fwd_rows`) for this input."""
    return (inp["rows"], inp["prim_idx"], inp["valid"], inp["counts"],
            inp["grid_w"], inp["C"], keep_block)


def tile_plain(inp):
    """K4's plain version on this input: (acc, trans)."""
    from comfy3d_tpu_torch.ops import gs_tile
    return gs_tile.composite_tiles_fwd_plain(inp["data"], inp["counts"],
                                             inp["grid_w"], inp["C"])


def tile_to_image(acc, trans, inp):
    from comfy3d_tpu_torch.ops import binning
    geo = (inp["grid_h"], inp["grid_w"], inp["H"], inp["W"])
    img = binning.tiles_to_image(acc.transpose(1, 2), *geo)
    tr = binning.tiles_to_image(trans.transpose(1, 2), *geo)
    return img[..., :-1] + tr * 1.0         # rgb + (1 - alpha) · white


def tile_visits(inp, block=8192):
    """The walked slot-pixel visits of this input (slots below each tile's
    count × 256 pixels), of those the live ones (power ≤ 0, op·G ≥ 1/255)
    and of those the unsaturated ones (op·G < 0.99), evaluated with the
    kernels' operations; the walked slots; and slot_warps_live, the per-slot
    tile backward's warp reductions (walked slots × the 8 warps of 32
    pixels with a live lane)."""
    import torch
    from comfy3d_tpu_torch.ops.gs_tile import ALPHA_MAX, ALPHA_MIN, TILE
    data, counts = inp["data"], inp["counts"]
    dev = data.device
    m = data.shape[2]
    t, slot = (torch.arange(m, device=dev)[None, :]
               < counts[:, None]).nonzero(as_tuple=True)
    p = torch.arange(TILE * TILE, device=dev)
    live = unsat = warps_live = 0
    for lo in range(0, t.numel(), block):
        tt, ss = t[lo:lo + block], slot[lo:lo + block]
        cols = data[tt, :, ss]                          # [b, D]
        px = (p % TILE).float()[None, :] + 0.5 \
            + ((tt % inp["grid_w"]) * TILE).float()[:, None]
        py = torch.div(p, TILE, rounding_mode="floor").float()[None, :] \
            + 0.5 + (torch.div(tt, inp["grid_w"], rounding_mode="floor")
                     * TILE).float()[:, None]
        mx = cols[:, 0:1] - px
        my = cols[:, 1:2] - py
        a, b, c, op = (cols[:, i:i + 1] for i in (2, 3, 4, 5))
        power = -0.5 * (a * mx * mx + c * my * my) - b * mx * my
        raw = op * torch.exp(torch.clamp_max(power, 0.0))
        hit = (power <= 0.0) & (raw >= ALPHA_MIN)
        live += int(hit.sum())
        unsat += int((hit & (raw < ALPHA_MAX)).sum())
        warps_live += int(hit.reshape(-1, 8, 32).any(-1).sum())
    return dict(slots=t.numel(), visits=t.numel() * TILE * TILE, live=live,
                unsat=unsat, slot_warps_live=warps_live)


def tile_box_stats(inp, block=8192):
    """The per-splat box (`gs_tile.splat_box`) on this tile input: the
    share of warp-slots (walked slots × the 8 warps of two pixel rows) whose
    rectangle misses the box, the visits the box admits (32 per warp-slot
    that is not skipped), and the live visits (power ≤ 0, op·G ≥ 1/255, in
    the kernels' operations) whose pixel lies outside the box, which must
    be 0."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    from comfy3d_tpu_torch.ops.gs_tile import ALPHA_MIN, TILE
    data, counts = inp["data"], inp["counts"]
    dev = data.device
    m = data.shape[2]
    t, slot = (torch.arange(m, device=dev)[None, :]
               < counts[:, None]).nonzero(as_tuple=True)
    p = torch.arange(TILE * TILE, device=dev)
    w = torch.arange(8, device=dev).float()
    skipped = outside = 0
    for lo in range(0, t.numel(), block):
        tt, ss = t[lo:lo + block], slot[lo:lo + block]
        cols = data[tt, :, ss]                          # [b, D]
        box = gs_tile.splat_box(*(cols[:, i] for i in range(6)))
        ox = ((tt % inp["grid_w"]) * TILE).float()
        oy = (torch.div(tt, inp["grid_w"], rounding_mode="floor")
              * TILE).float()
        miss = gs_tile.box_misses(
            [b[:, None] for b in box], ox[:, None] + 0.5,
            ox[:, None] + 15.5, oy[:, None] + 2 * w + 0.5,
            oy[:, None] + 2 * w + 1.5)                  # [b, 8]
        skipped += int(miss.sum())
        px = (p % TILE).float()[None, :] + 0.5 + ox[:, None]
        py = torch.div(p, TILE, rounding_mode="floor").float()[None, :] \
            + 0.5 + oy[:, None]
        mx = cols[:, 0:1] - px
        my = cols[:, 1:2] - py
        a, b, c, op = (cols[:, i:i + 1] for i in (2, 3, 4, 5))
        power = -0.5 * (a * mx * mx + c * my * my) - b * mx * my
        raw = op * torch.exp(torch.clamp_max(power, 0.0))
        hit = (power <= 0.0) & (raw >= ALPHA_MIN)
        x0, x1, y0, y1 = (v[:, None] for v in box)
        inside = (x0 <= px) & (px <= x1) & (y0 <= py) & (py <= y1)
        outside += int((hit & ~inside).sum())
    warp_slots = t.numel() * 8
    return dict(warp_slots=warp_slots, warp_slots_skipped=skipped,
                skip_share=skipped / max(warp_slots, 1),
                box_visits=(warp_slots - skipped) * 32,
                live_outside_box=outside)


def flat_box_stats(inp, stops, block=16384):
    """`tile_box_stats` for a coarse-bin input (bin_px 32) and the stops of
    its forward: warp-slots are the walked (pair, sub-tile) footprint
    entries × 8 warps; the box is taken in the bin-local frame
    (mxl = μx − the bin's origin) the kernels stage, and a live visit
    there is op·G ≥ 1/255 (K1's test has no power ≤ 0)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    from comfy3d_tpu_torch.ops.gs_flat import ALPHA_MIN, TILE
    data, C = inp["data"], inp["C"]
    g, t, q = pair_bins(inp)
    walk = walked_subtiles(inp, stops, t, q)
    dev = data.device
    p = torch.arange(TILE * TILE, device=dev)
    s = torch.arange(4, device=dev)
    sx0 = ((s % 2) * TILE).float()
    sy0 = (torch.div(s, 2, rounding_mode="floor") * TILE).float()
    px = (p % TILE).float()[None, :] + (sx0[:, None] + 0.5)     # [4, 256]
    py = torch.div(p, TILE, rounding_mode="floor").float()[None, :] \
        + (sy0[:, None] + 0.5)
    w = torch.arange(8, device=dev).float()
    entries = skipped = outside = 0
    for lo in range(0, g.numel(), block):
        sl = slice(lo, min(lo + block, g.numel()))
        tt = t[sl]
        mxl = data[0, sl] - ((tt % inp["nbx"]) * 2 * TILE).float()
        myl = data[1, sl] - (torch.div(tt, inp["nbx"], rounding_mode="floor")
                             * 2 * TILE).float()
        r = data[6 + C, sl]
        ov = walk[sl] & ((mxl[:, None] + r[:, None] > sx0)
                         & (mxl[:, None] - r[:, None] < sx0 + TILE)
                         & (myl[:, None] + r[:, None] > sy0)
                         & (myl[:, None] - r[:, None] < sy0 + TILE))
        a, b, c, op = (data[i, sl] for i in (2, 3, 4, 5))
        box = gs_tile.splat_box(mxl, myl, a, b, c, op)
        e3 = (slice(None), None, None)
        miss = gs_tile.box_misses(
            [v[e3] for v in box], sx0[None, :, None] + 0.5,
            sx0[None, :, None] + 15.5, sy0[None, :, None] + 2 * w + 0.5,
            sy0[None, :, None] + 2 * w + 1.5)          # [b, 4, 8]
        entries += int(ov.sum())
        skipped += int((miss & ov[..., None]).sum())
        dx = px - mxl[e3]
        dy = py - myl[e3]
        a, b, c, op = (x[e3] for x in (a, b, c, op))
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        raw = op * torch.exp(torch.clamp_max(power, 0.0))
        hit = ov[..., None] & (raw >= ALPHA_MIN)
        x0, x1, y0, y1 = (v[e3] for v in box)
        inside = (x0 <= px) & (px <= x1) & (y0 <= py) & (py <= y1)
        outside += int((hit & ~inside).sum())
    warp_slots = entries * 8
    return dict(warp_slots=warp_slots, warp_slots_skipped=skipped,
                skip_share=skipped / max(warp_slots, 1),
                box_visits=(warp_slots - skipped) * 32,
                live_outside_box=outside)


def check_box(box, what):
    """The per-splat box's gate: no live visit outside the box."""
    check(box["live_outside_box"] == 0,
          f"{what}: {box['live_outside_box']} live visits outside the box")


def _bound(in_bytes, out_bytes, ops, **counts):
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return dict(counts, ops=ops, bytes=in_bytes + out_bytes,
                bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


# f32 comparisons of the per-splat box test, per warp-slot (box_misses)
BOX_TEST_OPS = 4


def _full_walk(ops):
    """The operations of the design that tests every walked visit, and
    their time at the f32 peak: kept beside a bound for reference only."""
    return dict(ops_full_walk=ops,
                bound_ms_full_walk=ops / PEAK_F32_OPS_S * 1e3)


def tile_fwd_bound(inp, box, keep_block=False):
    """The least time of K4′'s function, the tile forward with its row
    gather, on this input: bytes (the walked slots' indices and valid
    flags, the distinct splat rows they hold (6 + C values each) and the
    counts read, acc and trans written, and the walked slots' D-wide block
    columns when the block is kept, each once) against the f32 operations
    this input needs, counted from csrc/gs_tile_fwd.cu: 17 per visit the
    per-splat box admits (`box`, `tile_box_stats`: offsets, power, exp,
    raw, tests), 4 + 2C more per live one (α, α·T, acc, T), and the box
    test of every warp-slot (a visit outside the box is dead wherever its
    pixel lies, so it needs nothing more). Beside it, for reference only,
    the count of the full walk (17 per walked slot-pixel visit)."""
    import torch
    C, ntiles = inp["C"], inp["prim_idx"].shape[0]
    v = tile_visits(inp)
    walked = torch.arange(inp["prim_idx"].shape[1],
                          device=inp["counts"].device)[None, :] \
        < inp["counts"][:, None]
    splats = int(torch.unique(inp["prim_idx"][walked]).numel())
    block = v["slots"] * inp["rows"].shape[1] * 4 if keep_block else 0
    live_ops = (4 + 2 * C) * v["live"]
    return _bound(v["slots"] * 9 + splats * (6 + C) * 4 + ntiles * 4,
                  ntiles * (C + 1) * 256 * 4 + block,
                  17 * box["box_visits"] + live_ops
                  + BOX_TEST_OPS * box["warp_slots"],
                  splats_read=splats, block_kept=keep_block,
                  box_visits=box["box_visits"],
                  warp_slots=box["warp_slots"], **v,
                  **_full_walk(17 * v["visits"] + live_ops))


def flat_fwd_bound(inp, stops, box=None):
    """The least time of K1′'s function, the coarse-bin forward with its
    row gather, on this input (bin_px 32) and the stops of its run: bytes
    (the pairs' indices, the distinct splat rows they hold (7 + C values
    each) and the bounds read, acc, trans and stops written, each once)
    against the f32 operations this input needs: 20 + 2C per footprint
    visit the per-splat box admits (`box`, `flat_box_stats` for these
    stops, computed when not given) and the box test of every footprint
    warp-slot. Beside it, for reference only, the count of the full walk
    (20 + 2C per footprint visit, `visits`: pairs of the composited chunks
    whose 3σ square meets a sub-tile, × 256 pixels)."""
    import torch
    C = inp["C"]
    if box is None:
        box = flat_box_stats(inp, stops)
    nbins = inp["nbx"] * inp["nby"]
    nsub = (inp["bin_px"] // 16) ** 2
    pairs = int(inp["bounds"][-1])
    splats = int(torch.unique(inp["sprim"][:pairs]).numel())
    v = visits(inp, stops)
    return _bound(pairs * 8 + splats * (7 + C) * 4 + (nbins + 1) * 4,
                  nbins * nsub * ((C + 1) * 256 * 4 + 4),
                  (20 + 2 * C) * box["box_visits"]
                  + BOX_TEST_OPS * box["warp_slots"],
                  visits=v, box_visits=box["box_visits"],
                  warp_slots=box["warp_slots"], splats_read=splats,
                  **_full_walk((20 + 2 * C) * v))


def tile_bwd_bound(inp):
    """The least time of K5's function, the tile backward with its
    per-splat scatter, on this input: bytes (the walked slots' 6 + C rows,
    splat indices and valid flags, counts, trans, g_acc and g_trans read,
    the [n, 6 + C] per-splat rows written, each once) against f32
    operations counted from the kernel's arithmetic: 17 per visit, 11 + 4C
    more per live one (one_m, log1p, log T, clamp, exp, α·T, chan·g, d chan
    and its sum, S), 35 more per unsaturated one (dα, d power, d μ, d conic,
    d op and their sums), and 6 + C adds per walked slot."""
    C = inp["C"]
    ntiles = inp["data"].shape[0]
    v = tile_visits(inp)
    return _bound(v["slots"] * ((6 + C) * 4 + 8 + 1) + ntiles * 4
                  + ntiles * (C + 2) * 256 * 4, inp["n"] * (6 + C) * 4,
                  17 * v["visits"] + (11 + 4 * C) * v["live"]
                  + 35 * v["unsat"] + (6 + C) * v["slots"], **v)


def old_design(reductions, nchan, walks, clock_mhz):
    """The per-slot design's backward kernels reduce each slot's 6 + C
    sums per warp with 5 warp shuffles each: their shuffles on this input
    and the least time the card takes to issue them (one shuffle per clock
    per SM, 132 SMs, at `clock_mhz`, nvidia-smi's clocks.max.sm), beside
    the CTAs' walk lengths in 128-slot chunks."""
    shuffles = reductions * (6 + nchan) * 5
    walks = walks.float()
    return dict(warp_reductions=reductions, shuffles=shuffles,
                shuffle_bound_ms=shuffles / (132 * clock_mhz * 1e6) * 1e3,
                sm_clock_max_mhz=clock_mhz, ctas=walks.numel(),
                walk_chunks_max=int(walks.max()),
                walk_chunks_mean=float(walks.mean()))


def scatter_columns(rows, idx, n, nchan):
    """The per-slot design's per-step scatter: per-slot (or per-pair) rows
    [S, D] added per splat by four `index_add_`s, as `_CompositeTiles` /
    `_CompositeFlat.backward` did."""
    def one(r):
        return r.new_zeros((n,) + r.shape[1:]).index_add_(0, idx, r)
    return (one(rows[:, 0:2]), one(rows[:, 2:5]), one(rows[:, 5]),
            one(rows[:, 6:6 + nchan]))


def tile_kernel_vs_plain(label, inp):
    """K4′ against its plain version on the gathered block: acc/trans max
    abs error and the image's PSNR; and the block K4′ writes for the
    backward against the gathered one on every slot below each tile's
    count (equal), finite and with opacity 0 from there to the end of the
    last walked chunk (the kernel writes zeros)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    acc, tr, block = gs_tile.composite_tiles_fwd_rows(
        *tile_kernel_args(inp, True))
    torch.cuda.synchronize()
    p_acc, p_tr = tile_plain(inp)
    err_acc = float((acc - p_acc).abs().max())
    err_tr = float((tr - p_tr).abs().max())
    plain_img = tile_to_image(p_acc, p_tr, inp)
    db = psnr(tile_to_image(acc, tr, inp), plain_img)
    m = block.shape[2]
    slot = torch.arange(m, device=block.device)[None, :]
    below = slot < inp["counts"][:, None]
    tail = ~below & (slot < (inp["counts"][:, None] + 127) // 128 * 128)
    block_equal = bool(torch.equal(block.transpose(1, 2)[below],
                                   inp["data"].transpose(1, 2)[below]))
    tail_cols = block.transpose(1, 2)[tail]
    tail_zero = not bool(tail_cols[:, 5].any()) \
        and bool(torch.isfinite(tail_cols).all())
    rec = dict(max_abs_err_acc=err_acc, max_abs_err_trans=err_tr,
               psnr_db=db, walked_slots=int(inp["counts"].sum()),
               max_count=int(inp["counts"].max()),
               max_per_tile=m, overflow=inp["overflow"],
               block_equal_below_count=block_equal,
               block_tail_transparent=tail_zero)
    log(f"tile {label}: {rec}")
    check(bool(torch.isfinite(acc).all()) and bool(torch.isfinite(tr).all()),
          f"tile {label}: non-finite")
    check(err_acc <= TOL_ABS and err_tr <= TOL_ABS,
          f"tile {label}: acc err {err_acc}, trans err {err_tr} > {TOL_ABS}")
    check(db >= TOL_PSNR_DB, f"tile {label}: PSNR {db:.2f} dB < "
          f"{TOL_PSNR_DB}")
    check(block_equal, f"tile {label}: K4′'s block differs from the gather")
    check(tail_zero, f"tile {label}: K4′'s block past the count (to the end "
          f"of the last walked chunk) is not finite with opacity 0")
    return rec, (acc, tr, block), plain_img


def tile_bwd_args(inp, fwd, seed):
    """K5′'s arguments (`composite_tiles_bwd_splats`) for a forward kernel's
    (acc, trans, block), fed the block K4′ wrote, with cotangents drawn
    from a seeded generator on the card; and the per-slot plain function's
    (`composite_tiles_bwd_plain`) for the same inputs on the gathered
    block."""
    import torch
    acc, trans, block = fwd
    gen = torch.Generator(device=acc.device).manual_seed(seed)
    g_acc = torch.randn(acc.shape, generator=gen, device=acc.device)
    g_trans = torch.randn(trans.shape, generator=gen, device=acc.device)
    return ((block, inp["counts"], inp["prim_idx"], inp["valid"],
             inp["n"], inp["grid_w"], trans, g_acc, g_trans, inp["C"]),
            (inp["data"], inp["counts"], inp["grid_w"], trans, g_acc,
             g_trans, inp["C"]))


def tile_bwd_vs_plain(label, inp, fwd, seed):
    """K5′, fed K4′'s block, against its plain version on the gathered
    block (`splat_rows_vs_plain`)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    args, slot_args = tile_bwd_args(inp, fwd, seed)
    k = gs_tile.composite_tiles_bwd_splats(*args)
    torch.cuda.synchronize()
    p = gs_tile.composite_tiles_bwd_splats_plain(inp["data"], *args[1:])
    rows, idx = walked_slot_rows(
        inp, gs_tile.composite_tiles_bwd_plain(*slot_args))
    return splat_rows_vs_plain(f"tile {label}", k, p, rows, idx)


def tile_cap_below_chunk(parity_scene):
    """`render_arrays(backend="tile", max_per_tile=64, chunk=8)` on the
    card, whose lists the renderer pads to the kernels' 128-slot chunks,
    against the same call with the plain versions in place of the two
    kernel wrappers, on the same inputs (the parity scene, its scales made
    anisotropic): outputs and the gradients of a seeded random cotangent,
    with the kernels' launch counts."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    from comfy3d_tpu_torch.ops import gs_render as G
    max_per_tile, chunk = 64, 8
    p_splat, p_cam = parity_scene
    w2c = p_cam.w2c.reshape(-1, 4, 4)[0]
    intr = p_cam.intrinsics.reshape(-1, 4)[0]
    W, H = p_cam.width, p_cam.height
    gen = torch.Generator(device=w2c.device).manual_seed(9)
    # the scene's scales made anisotropic, so the rotations take gradients
    leaves = [x.detach().clone() for x in (
        p_splat.xyz, p_splat.scale * (0.5 + torch.rand(
            p_splat.scale.shape, generator=gen, device=w2c.device)),
        p_splat.rotation, p_splat.opacity,
        p_splat.colors_toward(p_cam.campos.reshape(-1, 3)[0]))]
    cot = {k: torch.rand(shape, generator=gen, device=w2c.device)
           for k, shape in (("image", (H, W, 3)), ("alpha", (H, W)),
                            ("depth", (H, W)))}

    def run():
        xs = [x.clone().requires_grad_() for x in leaves]
        out = G.render_arrays(*xs, p_splat.alive, w2c, intr, W, H,
                              backend="tile", max_per_tile=max_per_tile,
                              chunk=chunk)
        sum((out[k] * c).sum() for k, c in cot.items()).backward()
        return out, [x.grad for x in xs]

    torch.cuda.synchronize()
    reset_launches()
    out, grads = run()
    torch.cuda.synchronize()
    launches = read_launches()
    kernels = (gs_tile.composite_tiles_fwd_rows,
               gs_tile.composite_tiles_bwd_splats)
    gs_tile.composite_tiles_fwd_rows = gs_tile.composite_tiles_fwd_rows_plain
    gs_tile.composite_tiles_bwd_splats = \
        gs_tile.composite_tiles_bwd_splats_plain
    try:
        ref, ref_grads = run()
    finally:
        (gs_tile.composite_tiles_fwd_rows,
         gs_tile.composite_tiles_bwd_splats) = kernels
    expect_launches(launches, "tile", 1, 1, f"the tile path at "
                    f"max_per_tile={max_per_tile}, chunk={chunk}")
    rec = {"max_per_tile": max_per_tile, "chunk": chunk,
           "launches": launches, "size": [W, H],
           "splats": int(leaves[0].shape[0]),
           "overflow": bool(out["overflow"])}
    for k in ("image", "alpha", "depth"):
        a, b = out[k].detach(), ref[k].detach()
        scale = max(1.0, float(b.abs().max()))
        rec[f"{k}_max_abs_err"] = float((a - b).abs().max())
        check(rec[f"{k}_max_abs_err"] <= TOL_ABS * scale,
              f"tile cap {max_per_tile}: {k} err {rec[k + '_max_abs_err']}")
    for name, g, r in zip(("xyz", "scale", "rotation", "opacity", "colors"),
                          grads, ref_grads):
        check(bool(r.abs().max() > 0), f"tile cap: d {name} is all zero")
        rec[f"d_{name}_rel_err"] = float((g - r).abs().max()
                                         / r.abs().max())
        check(rec[f"d_{name}_rel_err"] <= TOL_BWD_REL,
              f"tile cap {max_per_tile}: d {name} rel err "
              f"{rec['d_' + name + '_rel_err']} > {TOL_BWD_REL}")
    # the cap bites: some tile held more splats than it keeps
    check(rec["overflow"], f"no tile list reached {max_per_tile}")
    log(f"tile path at max_per_tile={max_per_tile}, chunk={chunk} (lists "
        f"padded to {gs_tile.CHUNK} slots), kernels vs plain: {rec}")
    return rec


def tile_render_path(dev, splat, cams, cam0, flat_imgs, parity_scene):
    """Phase 9: the tile render path, 8 views at 800², M = 1024 (the sizes
    are read from `splat` and `cams`)."""
    import torch
    from comfy3d_tpu_torch.ops import gs_tile
    from comfy3d_tpu_torch.ops import gs_render as G
    kw = dict(backend="tile", max_per_tile=1024)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = G.render(splat, cams, **kw)
    torch.cuda.synchronize()
    render8_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"tile render path: {cams.batch_shape} views in "
        f"{render8_s * 1e3:.1f} ms (first call), launches {launches}")
    nview, size = cams.batch_shape[0], cams.height
    expect_launches(launches, "tile", nview, 0, f"{nview} tile views")
    img, alpha = out["image"], out["alpha"]
    check(tuple(img.shape) == (nview, size, cams.width, 3),
          f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()) and bool(
        torch.isfinite(alpha).all()) and bool(
        torch.isfinite(out["depth"]).all()), "non-finite tile output")
    mean_alpha = float(alpha.mean())
    check(0.0 < mean_alpha < 1.0, f"tile mean alpha {mean_alpha}")
    vs_flat = [psnr(img[i], flat_imgs[i]) for i in range(nview)]
    # bench.py::bench_render_parity_psnr's scene: tile vs coarse-bin
    p_splat, p_cam = parity_scene
    parity_db = psnr(G.render(p_splat, p_cam, **dict(kw, max_per_tile=512))
                     ["image"], G.render(p_splat, p_cam)["image"])
    log(f"tile vs flat PSNR per view {vs_flat}; 20k/256² parity "
        f"{parity_db:.2f} dB")
    check(parity_db >= TOL_TILE_FLAT_DB, f"tile vs flat on the parity "
          f"scene: {parity_db:.2f} dB < {TOL_TILE_FLAT_DB}")
    cap_64 = tile_cap_below_chunk(parity_scene)

    inp = tile_inputs(splat, cam0, 1024)
    kargs = tile_kernel_args(inp, False)
    times = {
        "frame_ms": cuda_ms(lambda: G.render(splat, cam0, **kw), 20),
        "kernel_fwd_ms": cuda_ms(
            lambda: gs_tile.composite_tiles_fwd_rows(*kargs), 20),
        "plain_fwd_ms": cuda_ms(
            lambda: gs_tile.composite_tiles_fwd_rows_plain(*kargs), 3,
            warmup=1),
        "bin_primitives_ms": cuda_ms(
            lambda: G.binning.bin_primitives(*inp["bin_args"]), 20),
        # the gather K4′ took in (`_build_tile_data`), for reference
        "old_gather_ms": cuda_ms(
            lambda: G._build_tile_data(*inp["gather_args"]), 20),
        "prep_ms": cuda_ms(lambda: tile_inputs(splat, cam0, 1024), 20),
        "render_8_views_ms": cuda_ms(lambda: G.render(splat, cams, **kw), 5),
    }
    log(f"tile times at 800²/100k: {times}")
    prof = profile_frames(lambda: G.render(splat, cam0, **kw), 5,
                          rows=tuple(inp["rows"].shape))
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] \
        / times["frame_ms"]
    log(f"profile of one tile frame: {prof}")
    check(prof["row_gathers"] == 0, f"the tile frame still gathers splat "
          f"rows: {prof['row_gather_ops']}")
    box = tile_box_stats(inp)
    log(f"tile render view 0, per-splat box: {box}")
    check_box(box, "tile render view 0")
    rec = dict(views=nview, size=size, splats=splat.num_capacity,
               max_per_tile=1024,
               launches=launches, mean_alpha=mean_alpha,
               overflow_views=int(out["overflow"].sum()),
               vs_flat_psnr_db=vs_flat, parity_20k_256_psnr_db=parity_db,
               first_call_8_views_s=render8_s, box=box,
               cap_64_chunk_8=cap_64)
    return rec, times, prof, tile_fwd_bound(inp, box)


# ------------------------------------------------------------------ #
# TripoSR image → mesh (phase 11)
# ------------------------------------------------------------------ #
TOL_TRIPOSR_REL = 1e-3   # card vs CPU, of the largest value, TF32 off
TOL_MESH_V = 1e-5        # analytic mesh, card vs CPU
PROBES = 32768
CPU_LAYERS = 2           # ViT and backbone layers of the card-vs-CPU check
MESH_RES = 256           # extract_mesh's resolution (bumped to 257)
ANALYTIC_RES = 257       # the analytic sphere's lattice
RENDER_PX = 128          # the orbit render's size


def rel_err(a, b):
    """max |a - b| over max |b|, with b on the CPU."""
    a = a.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def sphere_density(pts):
    """0.5 − |p|: a sphere of radius 0.5, positive inside, in separate
    elementwise operations so every device rounds alike. The square root
    is taken in float64: PyTorch's CUDA float32 `sqrt` differs from the
    CPU's correctly rounded one by an ulp on 0.6 % of uniform inputs in
    [0, 1) (measured on an H100)."""
    import torch
    x, y, z = pts.unbind(-1)
    return 0.5 - torch.sqrt((x * x + y * y + z * z).double()).float()


def mesh_area(v, f):
    a, b, c = (v[f[:, i].long()] for i in range(3))
    return float(0.5 * (b - a).cross(c - a, dim=-1).norm(dim=-1).sum())


def profile_spans(fn, names):
    """One call of fn under torch.profiler: its wall seconds and, for each
    `record_function` span in `names`, its calls, the host ms it lasted and
    the device ms of the device ops launched while it lasted, from any
    thread (the autograd engine launches the backward's kernels from its
    own). Read from the profiler's raw Kineto events: a device op belongs
    to the op that launched it (`linked_correlation_id`), and that op to
    the span it started in; no event tree is built, so a trace of a
    million events is read in seconds. Returns (fn's result, its wall
    seconds, the spans, the seconds the profiler took to stop and be
    read)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    intervals = {name: [] for name in names}
    op_start, dev_ns = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() in intervals:
                intervals[e.name()].append((e.start_ns(), e.end_ns()))
            op_start[e.correlation_id()] = e.start_ns()
        else:
            c = e.linked_correlation_id()
            dev_ns[c] = dev_ns.get(c, 0) + e.duration_ns()
    spans = {name: {"calls": len(iv),
                    "host_ms": sum(b - a for a, b in iv) / 1e6,
                    "device_ms": 0.0} for name, iv in intervals.items()}
    for c, ns in dev_ns.items():
        t = op_start.get(c)
        for name, iv in intervals.items():
            if t is not None and any(a <= t <= b for a, b in iv):
                spans[name]["device_ms"] += ns / 1e6
    return out, t1 - t0, spans, time.perf_counter() - t1


def triposr_path(dev, asset_dir, smi_line):
    """Phase 11, at `TripoSRConfig()`'s widths."""
    import dataclasses
    import warnings

    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models.triposr import (TripoSRConfig,
                                                  TripoSRPipeline)
    from comfy3d_tpu_torch.models.triposr.pipeline import EXTRACT_STAGES
    from comfy3d_tpu_torch.ops import tetra, volume

    cfg = TripoSRConfig()
    r = cfg.radius
    s = cfg.cond_image_size
    rec = {"card": smi_line, "config": dataclasses.asdict(cfg), "seed": 0}
    img = np.random.RandomState(0).rand(1, s, s, 3).astype(np.float32)
    probe_np = np.random.RandomState(2).uniform(
        -r, r, (PROBES, 3)).astype(np.float32)
    cpu = torch.device("cpu")

    # a. the card against the port's CPU path, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    small = dataclasses.replace(cfg, vit_layers=CPU_LAYERS,
                                num_layers=CPU_LAYERS)
    th = time.perf_counter()
    host = TripoSRPipeline.init_random(0, small, device=cpu)
    with torch.no_grad():
        h_codes = host.scene_codes(img)
        h_sig, h_rgb = host.model.query(h_codes[0], torch.as_tensor(probe_np))
    host_s = time.perf_counter() - th
    card = pipe_on(host, dev)
    del host
    with torch.no_grad():
        c_codes = card.scene_codes(img)
        c_sig, c_rgb = card.model.query(c_codes[0],
                                        torch.as_tensor(probe_np, device=dev))
    del card
    parity = {"layers": CPU_LAYERS, "host_s": host_s,
              "codes_rel_err": rel_err(c_codes, h_codes),
              "sigma_rel_err": rel_err(c_sig, h_sig),
              "rgb_rel_err": rel_err(c_rgb, h_rgb),
              "codes_shape": list(c_codes.shape)}
    log(f"triposr a. card vs CPU ({CPU_LAYERS}+{CPU_LAYERS} layers, TF32 "
        f"off; host {host_s:.1f} s): {parity}")
    check(tuple(c_codes.shape) == (1, 3, cfg.triplane_channels,
                                   2 * cfg.plane_size, 2 * cfg.plane_size),
          f"scene codes {tuple(c_codes.shape)}")
    for k in ("codes", "sigma", "rgb"):
        check(parity[f"{k}_rel_err"] <= TOL_TRIPOSR_REL,
              f"triposr {k}: card vs CPU {parity[k + '_rel_err']:.3g} of "
              f"the largest value")
    rec["card_vs_cpu"] = parity
    rec["a_s"] = time.perf_counter() - t0

    # b. full depth: scene codes by CUDA events, peak memory
    t0 = time.perf_counter()
    pipe = TripoSRPipeline.init_random(0, cfg, device=dev)
    init_s = time.perf_counter() - t0
    img_dev = torch.as_tensor(img, device=dev)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in pipe.model.parameters())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    codes_ms = cuda_ms(lambda: pipe.scene_codes(img_dev), 5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    codes_tf32_ms = tf32_ms(lambda: pipe.scene_codes(img_dev), 5)
    codes = pipe.scene_codes(img_dev)
    check(bool(torch.isfinite(codes).all()), "non-finite scene codes")
    rec["scene_codes"] = {
        "ms": codes_ms, "ms_tf32": codes_tf32_ms, "init_s": init_s,
        "peak_bytes": peak, "weight_bytes": weight_bytes,
        "params": count_params(pipe.model)}
    log(f"triposr b. full depth: {rec['scene_codes']}")
    rec["b_s"] = time.perf_counter() - t0

    # c. an analytic sphere at 257³, card against CPU
    t0 = time.perf_counter()
    analytic = {}
    for d in (dev, cpu):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        grid = volume.decode_grid(sphere_density, ANALYTIC_RES, r, iso=0.0,
                                  device=d)
        torch.cuda.synchronize()
        tb = time.perf_counter()
        v, f, nv, nf = tetra.extract_isosurface_device(
            grid, iso=0.0, bounds=(-r, r), max_tris=2_000_000,
            on_overflow="raise")
        torch.cuda.synchronize()
        analytic[d.type] = dict(v=v[:nv].cpu(), f=f[:nf].cpu(), nv=nv, nf=nf,
                                decode_s=tb - ta,
                                sweep_weld_s=time.perf_counter() - tb)
        del grid
    a, b = analytic[dev.type], analytic["cpu"]
    area = mesh_area(a["v"], a["f"])
    sphere = {"nv": a["nv"], "nf": a["nf"], "cpu_nv": b["nv"],
              "cpu_nf": b["nf"], "area": area,
              "area_rel_err": abs(area - math.pi) / math.pi,
              "decode_s": a["decode_s"], "sweep_weld_s": a["sweep_weld_s"],
              "cpu_decode_s": b["decode_s"],
              "cpu_sweep_weld_s": b["sweep_weld_s"]}
    check((a["nv"], a["nf"]) == (b["nv"], b["nf"]),
          f"analytic mesh counts: card {a['nv']}/{a['nf']}, CPU "
          f"{b['nv']}/{b['nf']}")
    check(torch.equal(a["f"], b["f"]), "analytic mesh: faces differ")
    sphere["v_max_abs_err"] = float((a["v"] - b["v"]).abs().max())
    check(sphere["v_max_abs_err"] <= TOL_MESH_V,
          f"analytic mesh vertices: {sphere['v_max_abs_err']:.3g}")
    check(sphere["area_rel_err"] <= 0.01, f"analytic area {area:.5f}")
    log(f"triposr c. analytic sphere at {ANALYTIC_RES}³: {sphere}")
    rec["analytic_sphere"] = sphere
    del analytic, a, b
    rec["c_s"] = time.perf_counter() - t0

    # d. image → mesh at full width
    t0 = time.perf_counter()
    with torch.no_grad():
        sig = pipe.model.query(codes[0], torch.as_tensor(probe_np,
                                                         device=dev))[0]
    threshold = float(np.quantile(sig.cpu().numpy(), 0.98))
    kw = dict(resolution=MESH_RES, threshold=threshold,
              max_tris=2_000_000, on_overflow="warn", with_color=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe.extract_mesh(codes[0], **kw)                     # warm-up
        torch.cuda.synchronize()
        tm = time.perf_counter()
        mesh = pipe.extract_mesh(codes[0], **kw)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - tm
        # the split: the spans of one more call, profiled
        _, profiled_s, spans, _ = profile_spans(
            lambda: pipe.extract_mesh(codes[0], **kw), EXTRACT_STAGES)
    overflow = [str(w.message) for w in caught if "overflow" in
                str(w.message)]
    check(all(sp["calls"] == 1 for sp in spans.values()),
          f"extract_mesh's spans: {spans}")
    res = MESH_RES + 1 if volume.hier_plan(MESH_RES) is None else MESH_RES
    check(mesh.num_vertices > 0 and mesh.num_faces > 0, "empty mesh")
    check(bool(np.isfinite(mesh.v).all()) and
          np.abs(mesh.v).max() <= r + 1e-5, "mesh vertices off the box")
    check(int(mesh.f.max()) < mesh.num_vertices, "faces past the vertices")
    check(mesh.vc is not None and mesh.vc.shape == mesh.v.shape,
          "no vertex colours")
    glb = os.path.join(asset_dir, "triposr_mesh.glb")
    mesh.write(glb)
    back = Mesh.load(glb)
    check(np.array_equal(back.v, mesh.v) and np.array_equal(back.f, mesh.f),
          "GLB round trip changed the mesh")
    rec["image_to_mesh"] = {
        "resolution": res, "threshold": threshold, "max_tris": 2_000_000,
        "nv": mesh.num_vertices, "nf": mesh.num_faces,
        "overflow": bool(overflow), "overflow_warnings": overflow,
        "total_s": total_s, "profiled_total_s": profiled_s,
        "stages": {k.split(".")[-1]: v for k, v in spans.items()},
        "glb_bytes": os.path.getsize(glb)}
    log(f"triposr d. image → mesh at {res}³: {rec['image_to_mesh']}")
    rec["d_s"] = time.perf_counter() - t0

    # e. one orbit render
    t0 = time.perf_counter()
    cam = Camera.from_orbit(0.0, 30.0, 1.9, fovy_deg=40.0, width=RENDER_PX,
                            height=RENDER_PX, device=dev)
    out = pipe.render(codes[0], cam)
    rgb, alpha = out["rgb"], out["alpha"]
    check(tuple(rgb.shape) == (RENDER_PX, RENDER_PX, 3),
          f"render shape {tuple(rgb.shape)}")
    check(all(bool(torch.isfinite(out[k]).all()) for k in out),
          "non-finite render")
    check(float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0 + 1e-6,
          f"alpha in [{float(alpha.min())}, {float(alpha.max())}]")
    torch.cuda.synchronize()
    rec["render"] = {"px": RENDER_PX, "mean_alpha": float(alpha.mean()),
                     "s": time.perf_counter() - t0}
    log(f"triposr e. {RENDER_PX}² render: {rec['render']}")
    rec["e_s"] = rec["render"]["s"]
    return rec


# ------------------------------------------------------------------ #
# InstantMesh posed views → mesh (phase 12)
# ------------------------------------------------------------------ #
TOL_IM_REL = 1e-3        # card vs CPU, of the largest value, TF32 off
IM_AZIMUTHS = (30.0, 90.0, 150.0, 210.0, 270.0, 330.0)
IM_ELEVATIONS = (20.0, -10.0, 20.0, -10.0, 20.0, -10.0)
IM_SIZE = 320            # the six views' size
IM_SPHERE_RES = 97       # the deformed analytic sphere's lattice
IM_RESOLUTIONS = (96, 129)   # extract_mesh: the bench's and the default


def deformed_sphere(res, scale):
    """The res³ lattice over the ±scale box, each vertex moved by a smooth
    field of up to a quarter cell, and a radius-0.6 sphere's SDF (> 0
    inside) at the moved vertices: numpy float32 from float64, so every
    device gets the same inputs."""
    from comfy3d_tpu_torch.ops import tetra
    import numpy as np
    verts = tetra.grid_vertices(res) * scale
    p = verts.astype(np.float64)
    d = 0.25 * (2 * scale / (res - 1)) * np.stack(
        [np.sin(3 * p[:, 1] + 1), np.sin(3 * p[:, 2] + 2),
         np.sin(3 * p[:, 0] + 3)], -1)
    v_def = (verts + d.astype(np.float32)).astype(np.float32)
    sdf = 0.6 - np.linalg.norm(v_def.astype(np.float64), axis=-1)
    return v_def, sdf.astype(np.float32)


class count_calls:
    """Counts the calls of `module.name` while the block runs."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def counted(*args, **kw):
            self.calls += 1
            return self.real(*args, **kw)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def instantmesh_path(dev, asset_dir, smi_line):
    """Phase 12, at `InstantMeshConfig()`'s widths (`bench.py::
    bench_instantmesh_wallclock`'s set-up). Returns (record, the 96³
    mesh)."""
    import dataclasses
    import warnings

    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models.instantmesh import (
        InstantMeshConfig, InstantMeshPipeline, orbit_poses_to_input_cameras)
    from comfy3d_tpu_torch.models.instantmesh.pipeline import EXTRACT_STAGES
    from comfy3d_tpu_torch.ops import tetra

    cfg = InstantMeshConfig()
    half = cfg.grid_scale * 0.5
    rec = {"card": smi_line, "config": dataclasses.asdict(cfg), "seed": 0,
           "views": len(IM_AZIMUTHS), "size": IM_SIZE}
    imgs = np.random.RandomState(1).rand(1, len(IM_AZIMUTHS), IM_SIZE,
                                         IM_SIZE, 3).astype(np.float32)
    cams = orbit_poses_to_input_cameras(np.array(IM_AZIMUTHS),
                                        np.array(IM_ELEVATIONS))[None]
    probe = torch.as_tensor(np.random.RandomState(2).uniform(
        -half, half, (PROBES, 3)).astype(np.float32))
    cpu = torch.device("cpu")

    # a. the card against the port's CPU path, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    small = dataclasses.replace(cfg, vit_layers=CPU_LAYERS,
                                transformer_layers=CPU_LAYERS)
    host = InstantMeshPipeline.init_random(0, small, device=cpu)
    outs = {}
    for d in (cpu, dev):
        th = time.perf_counter()
        pipe = pipe_on(host, d)
        with torch.no_grad():
            planes = pipe.forward_planes(imgs, cams)
            sdf, deform = pipe.model.query_geometry(planes[0], probe.to(d))
            rgb = pipe.model.query_color(planes[0], probe.to(d))
        outs[d.type] = dict(planes=planes, sdf=sdf, deform=deform, rgb=rgb,
                            s=time.perf_counter() - th)
        del pipe
    h, c = outs["cpu"], outs[dev.type]
    parity = {"layers": CPU_LAYERS, "host_s": h["s"],
              "planes_shape": list(c["planes"].shape)}
    for k in ("planes", "sdf", "deform", "rgb"):
        parity[f"{k}_rel_err"] = rel_err(c[k], h[k])
    log(f"instantmesh a. card vs CPU ({CPU_LAYERS}+{CPU_LAYERS} layers, "
        f"TF32 off): {parity}")
    lo = cfg.triplane_low_res
    check(tuple(c["planes"].shape) == (1, 3, cfg.triplane_dim, 2 * lo,
                                       2 * lo),
          f"planes {tuple(c['planes'].shape)}")
    for k in ("planes", "sdf", "deform", "rgb"):
        check(parity[f"{k}_rel_err"] <= TOL_IM_REL,
              f"instantmesh {k}: card vs CPU {parity[k + '_rel_err']:.3g} "
              f"of the largest value")
    rec["card_vs_cpu"] = parity
    del outs, h, c, host
    rec["a_s"] = time.perf_counter() - t0

    # b. full depth: forward_planes by CUDA events, peak memory
    t0 = time.perf_counter()
    pipe = InstantMeshPipeline.init_random(0, cfg, device=dev)
    init_s = time.perf_counter() - t0
    imgs_dev = torch.as_tensor(imgs, device=dev)
    cams_dev = torch.as_tensor(cams, device=dev)
    params = count_params(pipe.model)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    planes_ms = cuda_ms(lambda: pipe.forward_planes(imgs_dev, cams_dev), 5,
                        warmup=1)
    peak = torch.cuda.max_memory_allocated()
    planes_tf32_ms = tf32_ms(
        lambda: pipe.forward_planes(imgs_dev, cams_dev), 5)
    planes = pipe.forward_planes(imgs_dev, cams_dev)
    check(bool(torch.isfinite(planes).all()), "non-finite triplanes")
    rec["forward_planes"] = {
        "ms": planes_ms, "ms_tf32": planes_tf32_ms, "init_s": init_s,
        "peak_bytes": peak, "params": params,
        "weight_bytes": sum(p.numel() * p.element_size()
                            for p in pipe.model.parameters())}
    log(f"instantmesh b. full depth: {rec['forward_planes']}")
    rec["b_s"] = time.perf_counter() - t0

    # c. marching tets over a deformed lattice + weld, card against CPU
    t0 = time.perf_counter()
    v_def, sdf = deformed_sphere(IM_SPHERE_RES, half)
    swept = {}
    for d in (dev, cpu):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        soup, count, ovf = tetra.marching_tets_deformed(
            torch.as_tensor(v_def, device=d), torch.as_tensor(sdf, device=d),
            IM_SPHERE_RES, max_tris=262_144)
        v, f, nv, nf, v_ovf = tetra.weld_device(soup, count,
                                                max_verts=262_144)
        torch.cuda.synchronize()
        swept[d.type] = dict(v=v[:nv].cpu(), f=f[:nf].cpu(), nv=nv, nf=nf,
                             count=count, overflow=bool(ovf or v_ovf),
                             s=time.perf_counter() - ta)
    a, b = swept[dev.type], swept["cpu"]
    sphere = {"res": IM_SPHERE_RES, "triangles": a["count"], "nv": a["nv"],
              "nf": a["nf"], "cpu_nv": b["nv"], "cpu_nf": b["nf"],
              "overflow": a["overflow"] or b["overflow"], "s": a["s"],
              "cpu_s": b["s"]}
    check((a["count"], a["nv"], a["nf"]) == (b["count"], b["nv"], b["nf"]),
          f"deformed sphere counts: card {a['count']}/{a['nv']}/{a['nf']}, "
          f"CPU {b['count']}/{b['nv']}/{b['nf']}")
    check(not sphere["overflow"], "deformed sphere overflowed")
    check(torch.equal(a["f"], b["f"]), "deformed sphere: faces differ")
    sphere["v_max_abs_err"] = float((a["v"] - b["v"]).abs().max())
    check(sphere["v_max_abs_err"] <= TOL_MESH_V,
          f"deformed sphere vertices: {sphere['v_max_abs_err']:.3g}")
    log(f"instantmesh c. deformed sphere at {IM_SPHERE_RES}³: {sphere}")
    rec["deformed_sphere"] = sphere
    del swept, a, b
    rec["c_s"] = time.perf_counter() - t0

    # d. extract_mesh at the bench's 96 and the default 129
    t0 = time.perf_counter()
    meshes, rec["extract_mesh"] = {}, {}
    for res in IM_RESOLUTIONS:
        pipe._cap_memo.pop(res, None)
        with warnings.catch_warnings(record=True) as caught, \
                count_calls(tetra, "marching_tets_deformed") as rungs:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            tc = time.perf_counter()
            pipe.extract_mesh(planes[0], resolution=res)     # the ladder
            torch.cuda.synchronize()
            cold_s, cold_rungs = time.perf_counter() - tc, rungs.calls
            tm = time.perf_counter()
            mesh = pipe.extract_mesh(planes[0], resolution=res)
            torch.cuda.synchronize()
            total_s, warm_rungs = time.perf_counter() - tm, \
                rungs.calls - cold_rungs
            _, profiled_s, spans, _ = profile_spans(
                lambda: pipe.extract_mesh(planes[0], resolution=res),
                EXTRACT_STAGES)
        overflow = [str(w.message) for w in caught
                    if "overflow" in str(w.message)]
        check(all(sp["calls"] == 1 for sp in spans.values()),
              f"extract_mesh's spans: {spans}")
        check(mesh.num_vertices > 0 and mesh.num_faces > 0, "empty mesh")
        check(bool(np.isfinite(mesh.v).all()), "non-finite vertices")
        check(int(mesh.f.max()) < mesh.num_vertices, "faces past the vertices")
        check(mesh.vc is not None and mesh.vc.shape == mesh.v.shape,
              "no vertex colours")
        r = {"resolution": res, "nv": mesh.num_vertices,
             "nf": mesh.num_faces, "capacity": pipe._cap_memo[res],
             "cold_rungs": cold_rungs, "warm_rungs": warm_rungs,
             "overflow": bool(overflow), "overflow_warnings": overflow[:2],
             "cold_s": cold_s, "total_s": total_s,
             "profiled_total_s": profiled_s,
             "stages": {k.split(".")[-1]: v for k, v in spans.items()}}
        if res == IM_RESOLUTIONS[0]:
            glb = os.path.join(asset_dir, "instantmesh_mesh.glb")
            mesh.write(glb)
            back = Mesh.load(glb)
            check(np.array_equal(back.v, mesh.v)
                  and np.array_equal(back.f, mesh.f),
                  "GLB round trip changed the mesh")
            r["glb_bytes"] = os.path.getsize(glb)
        log(f"instantmesh d. extract_mesh at {res}³: {r}")
        rec["extract_mesh"][str(res)] = r
        meshes[res] = mesh
    rec["d_s"] = time.perf_counter() - t0
    del pipe, planes
    torch.cuda.empty_cache()
    return rec, meshes[IM_RESOLUTIONS[0]]


# ------------------------------------------------------------------ #
# The mesh orbit renderer (phase 13)
# ------------------------------------------------------------------ #
MR_SIZE = 512            # the Mesh_Orbit_Renderer node's defaults
MR_FOVY = 49.1
MR_RADIUS = 2.6          # the orbit's camera distance
# the sphere: radius 1 in a ±3 lattice of 97³ (28,524 faces), so no 16-px
# tile of the 8 views at 512² holds more than 216 faces: `max_per_tile`
# 256 cuts none, and binned must equal brute force
MR_SPHERE_RES = 97
MR_SPHERE_BOUND = 3.0
MR_TEXTURE = 1024
MR_BF_CHUNK = 128        # brute force's faces per step on the card
TOL_MR = 1e-4            # buffers where the face ids agree, card vs CPU
MR_FACE_AGREE = 0.999    # share of pixels whose face id agrees
TOL_MR_GRAD_REL = 1e-3   # gradients, card vs CPU, of their largest value


def sphere_mesh():
    """A unit sphere from `extract_isosurface_device` at MR_SPHERE_RES³ over
    ±MR_SPHERE_BOUND (on the CPU; the field rooted in float64), with vertex
    colours from the position."""
    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.ops import tetra
    bound = MR_SPHERE_BOUND
    lin = np.linspace(-bound, bound, MR_SPHERE_RES)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    grid = (1.0 - np.sqrt(x * x + y * y + z * z)).astype(np.float32)
    v, f, nv, nf = tetra.extract_isosurface_device(
        torch.as_tensor(grid), bounds=(-bound, bound), max_tris=400_000,
        on_overflow="raise")
    v, f = v[:nv].numpy(), f[:nf].numpy()
    return Mesh(v=v, f=f, vc=np.clip(v * 0.5 + 0.5, 0.0, 1.0))


def uv_sphere(n_lat=32, n_lon=64, radius=0.5, texture=None):
    """A latitude-longitude sphere of `radius` (y up), its points shared
    across the seam and at the poles, with per-corner UVs (vt/ft: u the
    longitude, v the latitude) and the albedo `texture` [T, T, 3] or None,
    its faces wound outwards."""
    import numpy as np
    from comfy3d_tpu_torch.core.mesh import Mesh
    theta = np.linspace(0.0, np.pi, n_lat + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    pts = radius * np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                             np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    uvs = np.stack([ph / (2.0 * np.pi), 1.0 - th / np.pi],
                   -1).reshape(-1, 2)
    idx = np.arange(pts.shape[0]).reshape(n_lat + 1, n_lon + 1)
    q0, q1, q2, q3 = (idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:],
                      idx[:-1, 1:])
    ft = np.concatenate([np.stack([q0, q2, q1], -1).reshape(-1, 3),
                         np.stack([q0, q3, q2], -1).reshape(-1, 3)])
    v, inv = np.unique(np.round(pts, 6), axis=0, return_inverse=True)
    f = inv.reshape(-1)[ft]
    keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    return Mesh(v=v, f=f[keep], vt=uvs, ft=ft[keep], albedo=texture)


def uv_cube():
    """A cube of half-size 0.5, each face split into 4 × 4 quads (two
    triangles each), its vertices shared between faces, with per-face UVs
    (vt/ft) into a 3 × 2 atlas of a seeded MR_TEXTURE² albedo."""
    import numpy as np
    from comfy3d_tpu_torch.core.mesh import Mesh
    n = 4
    s = np.linspace(-0.5, 0.5, n + 1)
    a, b = np.meshgrid(s, s, indexing="ij")
    pts, uvs, tris = [], [], []
    for k in range(6):
        axis, sign = k // 2, (-1.0, 1.0)[k % 2]
        p = np.zeros(a.shape + (3,))
        p[..., axis] = 0.5 * sign
        p[..., (axis + 1) % 3], p[..., (axis + 2) % 3] = a, b
        uv = np.stack([(k % 3 + a + 0.5) / 3.0,
                       (k // 3 + b + 0.5) / 2.0], -1)
        idx = k * (n + 1) ** 2 + np.arange((n + 1) ** 2).reshape(n + 1,
                                                                  n + 1)
        q0, q1, q2, q3 = (idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:],
                          idx[:-1, 1:])
        tris.append(np.stack([q0, q1, q2], -1).reshape(-1, 3))
        tris.append(np.stack([q0, q2, q3], -1).reshape(-1, 3))
        pts.append(p.reshape(-1, 3))
        uvs.append(uv.reshape(-1, 2))
    pts, uvs, ft = np.concatenate(pts), np.concatenate(uvs), \
        np.concatenate(tris)
    v, inv = np.unique(np.round(pts, 6), axis=0, return_inverse=True)
    albedo = np.random.RandomState(0).rand(MR_TEXTURE, MR_TEXTURE, 3)
    return Mesh(v=v, f=inv.reshape(-1)[ft], vt=uvs, ft=ft, albedo=albedo)


def render_inputs(mesh, device):
    """The orbit-renderer node's inputs: `Mesh.device_arrays` with
    `face_valid` over the padded faces, and the colour source."""
    import torch
    d = mesh.device_arrays(device=device)
    kw = dict(face_valid=torch.arange(d["f"].shape[0], device=device)
              < mesh.num_faces)
    if "albedo" in d and "ft" in d:
        kw.update(vt=d["vt"], ft=d["ft"], albedo=d["albedo"])
    elif "vc" in d:
        kw["vc"] = d["vc"]
    return d["v"], d["f"], kw


def orbit_cameras(device):
    """The 8-view orbit at MR_RADIUS."""
    from comfy3d_tpu_torch.core.camera import Camera, compose_orbit_camposes
    poses = compose_orbit_camposes([MR_RADIUS] * 8,
                                   [15.0, 30.0, 0.0, -15.0] * 2,
                                   [30.0 + 45.0 * i for i in range(8)])
    return Camera.from_camposes(poses, fovy_deg=MR_FOVY, width=MR_SIZE,
                                height=MR_SIZE, device=device)


def _view(cams, i):
    import dataclasses
    return dataclasses.replace(cams, c2w=cams.c2w[i],
                               fovy_deg=cams.fovy_deg[i])


def mesh_render_path(dev, im_mesh):
    """Phase 13: `render_mesh` with the Mesh_Orbit_Renderer node's defaults
    (fovy 49.1, background 1, "binned") on two fixtures, then the 8-view
    orbit batch, then phase 12's mesh."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.ops import mesh_render as MR
    from comfy3d_tpu_torch.ops import rasterize as R

    cpu = torch.device("cpu")
    size = MR_SIZE
    fixtures = {"sphere_vc": sphere_mesh(), "cube_albedo": uv_cube()}
    rec = {"size": size, "fovy": MR_FOVY, "radius": MR_RADIUS,
           "fixtures": {k: {"nv": m.num_vertices, "nf": m.num_faces}
                        for k, m in fixtures.items()}}
    # one set of camera poses, copied to the card: both devices see the
    # same c2w bits (a sin or cos on the card may differ by an ulp)
    cams = {"cpu": orbit_cameras(cpu)}
    cams[dev.type] = dataclasses.replace(
        cams["cpu"], c2w=cams["cpu"].c2w.to(dev),
        fovy_deg=cams["cpu"].fovy_deg.to(dev))

    # a. one view of each fixture, card against CPU; binned = brute force
    t0 = time.perf_counter()
    rec["parity"] = {}
    for name, mesh in fixtures.items():
        out = {}
        for d in (dev, cpu):
            v, f, kw = render_inputs(mesh, d)
            cam = _view(cams[d.type], 0)
            rast = R.rasterize(v, f, cam.view_proj, size, size,
                               face_valid=kw["face_valid"])
            img = MR.render_mesh(v, f, cam, **kw)
            out[d.type] = (rast, {k: x.cpu() for k, x in img.items()})
            if d == dev:
                brute = R.rasterize(v, f, cam.view_proj, size, size,
                                    face_valid=kw["face_valid"],
                                    method="bruteforce", chunk=MR_BF_CHUNK)
                same = {k: bool(torch.equal(getattr(rast, k),
                                            getattr(brute, k)))
                        for k in ("face_id", "bary", "depth")}
                check(all(same.values()),
                      f"{name}: binned differs from brute force: {same}")
        (cr, ci), (hr, hi) = out[dev.type], out["cpu"]
        agree = (cr.face_id.cpu() == hr.face_id)
        r = {"coverage": float(hi["alpha"].mean()),
             "face_id_agree": float(agree.float().mean())}
        for k in ("image", "alpha", "depth", "normal", "viewcos"):
            diff = (ci[k] - hi[k]).abs()
            if diff.dim() == 3:
                diff = diff.amax(-1)
            r[f"{k}_max_abs_err"] = float(diff[agree].max())
        log(f"mesh_render a. {name}, card vs CPU at {size}²: {r}")
        check(0.02 < r["coverage"] < 0.98, f"{name}: coverage {r}")
        check(r["face_id_agree"] >= MR_FACE_AGREE,
              f"{name}: face ids agree on {r['face_id_agree']:.5f}")
        for k in ("image", "alpha", "depth", "normal", "viewcos"):
            check(r[f"{k}_max_abs_err"] <= TOL_MR,
                  f"{name}: {k} card vs CPU {r[k + '_max_abs_err']:.3g}")
        rec["parity"][name] = r
    rec["a_s"] = time.perf_counter() - t0

    # b. gradients with respect to v, vc and albedo, card against CPU
    t0 = time.perf_counter()
    w = np.random.RandomState(5).rand(size, size, 3).astype(np.float32)
    rec["gradients"] = {}
    for name, mesh, leaf in (("sphere_vc", fixtures["sphere_vc"], "vc"),
                             ("cube_albedo", fixtures["cube_albedo"],
                              "albedo")):
        grads = {}
        for d in (dev, cpu):
            v, f, kw = render_inputs(mesh, d)
            v = v.clone().requires_grad_()
            kw[leaf] = kw[leaf].clone().requires_grad_()
            img = MR.render_mesh(v, f, _view(cams[d.type], 0), **kw)
            (img["image"] * torch.as_tensor(w, device=d)).sum().backward()
            grads[d.type] = {"v": v.grad.cpu(), leaf: kw[leaf].grad.cpu()}
        r = {}
        for k, g in grads[dev.type].items():
            ref = grads["cpu"][k]
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite d{k}")
            check(float(ref.abs().max()) > 0, f"{name}: d{k} is zero")
            r[f"d{k}_rel_err"] = rel_err(g, ref)
            check(r[f"d{k}_rel_err"] <= TOL_MR_GRAD_REL,
                  f"{name}: d{k} card vs CPU {r[f'd{k}_rel_err']:.3g}")
        log(f"mesh_render b. {name} gradients: {r}")
        rec["gradients"][name] = r
    rec["b_s"] = time.perf_counter() - t0

    # c. the 8-view orbit batch of the sphere
    t0 = time.perf_counter()
    v, f, kw = render_inputs(fixtures["sphere_vc"], dev)
    cam8, cam0 = cams[dev.type], _view(cams[dev.type], 0)
    out = MR.render_mesh(v, f, cam8, **kw)
    check(tuple(out["image"].shape) == (8, size, size, 3),
          f"8-view image {tuple(out['image'].shape)}")
    check(all(bool(torch.isfinite(x).all()) for x in out.values()),
          "non-finite 8-view render")
    batch_ms = cuda_ms(lambda: MR.render_mesh(v, f, cam8, **kw), 3,
                       warmup=1)
    frame_ms = cuda_ms(lambda: MR.render_mesh(v, f, cam0, **kw), 5,
                       warmup=1)
    raster_ms = cuda_ms(lambda: R.rasterize(
        v, f, cam0.view_proj, size, size, face_valid=kw["face_valid"]), 5,
        warmup=1)
    prof = profile_frames(lambda: MR.render_mesh(v, f, cam0, **kw), 3)
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / frame_ms
    ss = MR.render_mesh(v, f, cam0, ssaa=2, **kw)
    check(tuple(ss["image"].shape) == (size, size, 3)
          and all(bool(torch.isfinite(x).all()) for x in ss.values()),
          "ssaa=2 render")
    ssaa_ms = cuda_ms(lambda: MR.render_mesh(v, f, cam0, ssaa=2, **kw), 2,
                      warmup=0)
    rec["orbit"] = {"views": 8, "batch_ms": batch_ms,
                    "ms_per_frame": batch_ms / 8, "frame_ms": frame_ms,
                    "rasterize_ms": raster_ms, "ssaa2_frame_ms": ssaa_ms,
                    "mean_alpha": float(out["alpha"].mean()),
                    "profile": {k: x for k, x in prof.items() if k != "top"},
                    "profile_top": prof["top"][:6]}
    log(f"mesh_render c. 8-view orbit at {size}²: {rec['orbit']}")
    rec["c_s"] = time.perf_counter() - t0

    # d. phase 12's mesh from the same 8 views (a noise surface: tiles
    # may overflow, so nothing is gated but finiteness)
    t0 = time.perf_counter()
    v, f, kw = render_inputs(im_mesh, dev)
    out = MR.render_mesh(v, f, cam8, **kw)
    check(all(bool(torch.isfinite(x).all()) for x in out.values()),
          "non-finite render of the InstantMesh mesh")
    im_ms = cuda_ms(lambda: MR.render_mesh(v, f, cam8, **kw), 1, warmup=0)
    rec["instantmesh_mesh"] = {
        "nv": im_mesh.num_vertices, "nf": im_mesh.num_faces,
        "batch_ms": im_ms, "ms_per_frame": im_ms / 8,
        "covered_share": float(out["alpha"].mean())}
    log(f"mesh_render d. the InstantMesh mesh, 8 views: "
        f"{rec['instantmesh_mesh']}")
    rec["d_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------------ #
# MVDream text → four views → LGM → splats → gs_to_mesh's orbit (phase 14)
# ------------------------------------------------------------------ #
TOL_MV_REL = 1e-3        # card vs CPU, of the largest value, TF32 off
MV_STEPS = 30            # the MVDream_Model node's defaults
MV_GUIDANCE = 5.0
MV_ELEVATION = 0.0
# parameters of MVDreamConfig() and LGMConfig() (the JAX package's counts)
MV_PARAMS = {"unet": 859_520_964, "camera": 1_661_440, "vae": 83_653_863,
             "lgm": 412_958_240}
SPLAT_FIELDS = ("xyz", "sh", "opacity_raw", "scale_raw", "rot_raw")
# gs_to_mesh's supervision orbit: `algorithms/gs_to_mesh.py::orbit_cameras`
# at `GSToMeshConfig()` (24 views of 256², radius 2, fovy 49.1)
GS_ORBIT_VIEWS = 24
GS_ORBIT_SIZE = 256


def coarse_overflow(inp):
    """Of the splats the coarse sort bins, those whose box of bins spans
    more than k bins (they keep k), by `binning.coarse_footprint`."""
    from comfy3d_tpu_torch.ops import binning
    means2d, _, radii, active, nby, nbx, k = inp["sort_args"]
    _, _, w, h, act = binning.coarse_footprint(means2d, radii, active, nby,
                                               nbx, inp["bin_px"])
    bins = w * h
    n_act, n_over = int(act.sum()), int((act & (bins > k)).sum())
    return dict(splats_binned=n_act, splats_over_k=n_over,
                overflow_share=n_over / max(n_act, 1),
                max_bins=int(bins[act].max()) if n_act else 0)


def flops_of(fn):
    """The matmul, convolution and attention FLOPs of one call of fn, by
    `torch.utils.flop_counter`."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def mvdream_lgm_path(dev, asset_dir, smi_line):
    """Phase 14, at `MVDreamConfig()` and `LGMConfig()` widths with the
    MVDream_Model node's defaults (30 steps, CFG 5, elevation 0, seed 0,
    zero prompt embeddings). Runs under `torch.no_grad()`."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.io.ply import load_gs_ply, save_gs_ply
    from comfy3d_tpu_torch.models.diffusion.schedulers import (
        DDIM, SchedulerConfig)
    from comfy3d_tpu_torch.models.lgm import (LGMConfig, LGMPipeline,
                                              plucker_rays)
    from comfy3d_tpu_torch.models.mvdream import (MVDreamConfig,
                                                  MVDreamPipeline)
    from comfy3d_tpu_torch.algorithms.gs_to_mesh import (GSToMeshConfig,
                                                         orbit_cameras)
    from comfy3d_tpu_torch.ops import gs_flat
    from comfy3d_tpu_torch.ops import gs_render as G

    mv_cfg, lgm_cfg, g2m_cfg = MVDreamConfig(), LGMConfig(), GSToMeshConfig()
    check((g2m_cfg.n_views, g2m_cfg.render_size)
          == (GS_ORBIT_VIEWS, GS_ORBIT_SIZE), f"orbit of {g2m_cfg}")
    steps, orbit_size = MV_STEPS, GS_ORBIT_SIZE
    v = mv_cfg.num_views
    lat = mv_cfg.image_size // mv_cfg.vae_factor
    size = lgm_cfg.input_size
    azims = [i * 360.0 / v for i in range(v)]
    rec = {"card": smi_line, "seed": 0, "steps": steps,
           "guidance_scale": MV_GUIDANCE, "elevation": MV_ELEVATION,
           "prompt_embeds": "zeros",
           "mvdream_config": dataclasses.asdict(mv_cfg),
           "lgm_config": dataclasses.asdict(lgm_cfg)}
    rng = np.random.RandomState(0)
    x_np = rng.randn(v, 4, lat, lat).astype(np.float32)
    z_np = rng.randn(1, 4, lat, lat).astype(np.float32)
    views_np = rng.rand(v, size, size, 3).astype(np.float32)
    node = dict(guidance_scale=MV_GUIDANCE, elevation=MV_ELEVATION)
    t_first = int(DDIM(SchedulerConfig(), steps).timesteps[0])
    cpu = torch.device("cpu")

    # a. the card against the port's CPU path at layers_per_block 1, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    small_mv = dataclasses.replace(
        mv_cfg, unet=dataclasses.replace(mv_cfg.unet, layers_per_block=1),
        vae=dataclasses.replace(mv_cfg.vae, layers_per_block=1))
    small_lgm = dataclasses.replace(lgm_cfg, layers_per_block=1)
    host_mv = MVDreamPipeline.init_random(0, small_mv, device=cpu)
    host_lgm = LGMPipeline.init_random(0, small_lgm, device=cpu)
    outs = {}
    for d in (cpu, dev):
        th = time.perf_counter()
        mv, lgm = pipe_on(host_mv, d), pipe_on(host_lgm, d)
        x = torch.as_tensor(x_np, device=d)
        cond = mv.conditioning(elevation=MV_ELEVATION)
        states, cam2 = cond.states, cond.cam_emb
        o = {"unet": mv.model.unet(
                torch.cat([x, x]), torch.full((2 * v,), float(t_first),
                                              device=d),
                states, class_emb=cam2, mv_views=v),
             "ddim_2_steps": mv.sample_latents(num_inference_steps=2,
                                               latents=x, **node),
             "vae_decode": mv.model.vae.decode(torch.as_tensor(z_np,
                                                               device=d))}
        rays = plucker_rays(small_lgm, [0.0] * v, azims, device=d)
        o["lgm"] = lgm.model(torch.cat([torch.as_tensor(views_np, device=d),
                                        rays], -1).permute(0, 3, 1, 2))
        sp = lgm.forward_gaussians(views_np)
        o.update({f: getattr(sp, f) for f in SPLAT_FIELDS})
        torch.cuda.synchronize()
        outs[d.type] = o
        outs[d.type + "_s"] = time.perf_counter() - th
        del mv, lgm
    parity = {"layers_per_block": 1, "t": t_first,
              "host_s": outs["cpu_s"], "card_s": outs[dev.type + "_s"]}
    for k, ref in outs["cpu"].items():
        parity[f"{k}_rel_err"] = rel_err(outs[dev.type][k], ref)
    log(f"mvdream_lgm a. card vs CPU (layers_per_block 1, TF32 off): "
        f"{parity}")
    for k in outs["cpu"]:
        check(parity[f"{k}_rel_err"] <= TOL_MV_REL,
              f"mvdream_lgm {k}: card vs CPU {parity[k + '_rel_err']:.3g} "
              f"of the largest value")
    rec["card_vs_cpu"] = parity
    del outs, host_mv, host_lgm
    rec["a_s"] = time.perf_counter() - t0

    # b. full depth: text → four views by CUDA events, one denoise step
    t0 = time.perf_counter()
    # drawn on the card, as the loader nodes draw them: phase 19d's graph
    # builds the same weights
    mv = MVDreamPipeline.init_random(0, mv_cfg, device=dev)
    lgm = LGMPipeline.init_random(0, lgm_cfg, device=dev)
    init_s = time.perf_counter() - t0
    m = mv.model
    params = {"unet": count_params(m.unet),
              "camera": count_params(m.camera_embed),
              "vae": count_params(m.vae), "lgm": count_params(lgm.model)}
    check(params == MV_PARAMS, f"parameters {params}, not {MV_PARAMS}")

    def text_to_views():
        return mv(num_inference_steps=steps,
                  generator=torch.Generator().manual_seed(0), **node)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    views_ms = cuda_ms(text_to_views, 1, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    views_tf32_ms = tf32_ms(text_to_views, 1, warmup=0)
    views = text_to_views()
    check(tuple(views.shape) == (v, mv_cfg.image_size, mv_cfg.image_size,
                                 3), f"views {tuple(views.shape)}")
    check(bool(torch.isfinite(views).all()), "non-finite views")
    check(float(views.min()) >= 0.0 and float(views.max()) <= 1.0,
          "views outside [0, 1]")

    sched = DDIM(SchedulerConfig(), steps)
    cond = mv.conditioning(elevation=MV_ELEVATION)
    x0 = mv.initial_latents(torch.Generator().manual_seed(0))

    def one_step():
        eps = mv.guided_eps(x0, t_first, cond, MV_GUIDANCE)
        return sched.step(eps, 0, x0)

    step_ms = cuda_ms(one_step, 5, warmup=1)
    step_tf32_ms = tf32_ms(one_step, 5)
    prof = profile_frames(one_step, 3)
    # within the profiled window: the host's time per step there against
    # the time some device op ran
    prof["device_idle_share"] = 1.0 - prof["device_union_ms"] \
        / prof["window_ms"]
    decode_ms = cuda_ms(lambda: m.vae.decode(x0), 3, warmup=1)
    decode_tf32_ms = tf32_ms(lambda: m.vae.decode(x0), 3)
    step_flops = flops_of(one_step)
    decode_flops = flops_of(lambda: m.vae.decode(x0))
    rec["text_to_views"] = {
        "ms": views_ms, "ms_tf32": views_tf32_ms, "init_s": init_s,
        "peak_bytes": peak, "params": params,
        "weight_bytes": sum(p.numel() * p.element_size()
                            for p in list(m.parameters())
                            + list(lgm.model.parameters())),
        "clipped_share": float(((views == 0) | (views == 1)).float().mean()),
        "mean": float(views.mean()),
        "step_ms": step_ms, "step_ms_tf32": step_tf32_ms,
        "decode_ms": decode_ms, "decode_ms_tf32": decode_tf32_ms,
        "step_flops": step_flops, "decode_flops": decode_flops,
        "step_tflops_s": step_flops / step_ms / 1e9,
        "step_tflops_s_tf32": step_flops / step_tf32_ms / 1e9,
        "decode_tflops_s": decode_flops / decode_ms / 1e9,
        "step_profile": {k: x for k, x in prof.items() if k != "top"},
        "step_profile_top": prof["top"][:6]}
    log(f"mvdream_lgm b. full depth: {rec['text_to_views']}")
    rec["b_s"] = time.perf_counter() - t0

    # c. LGM: the four views → splats, GS-PLY round trip
    t0 = time.perf_counter()
    splat = lgm.forward_gaussians(views)
    lgm_ms = cuda_ms(lambda: lgm.forward_gaussians(views), 3, warmup=1)
    lgm_tf32_ms = tf32_ms(lambda: lgm.forward_gaussians(views), 3)
    lgm_flops = flops_of(lambda: lgm.forward_gaussians(views))
    n = v * lgm_cfg.splat_size ** 2
    check(splat.num_capacity == n and bool(splat.alive.all()),
          f"{splat.num_capacity} splats, not {n} alive")
    check(all(bool(torch.isfinite(getattr(splat, f)).all())
              for f in SPLAT_FIELDS), "non-finite splat fields")
    qn = torch.linalg.vector_norm(splat.rot_raw, dim=-1)
    check(float((qn - 1).abs().max()) <= 1e-5, "rotations not unit")
    ply = os.path.join(asset_dir, "lgm_splat.ply")
    save_gs_ply(ply, splat)
    back = load_gs_ply(ply, device=dev)
    check(back.device == splat.device and all(
        torch.equal(getattr(back, f), getattr(splat, f))
        for f in SPLAT_FIELDS), "GS-PLY round trip changed the splat")
    scale = splat.scale
    rec["forward_gaussians"] = {
        "ms": lgm_ms, "ms_tf32": lgm_tf32_ms, "splats": n,
        "flops": lgm_flops, "tflops_s": lgm_flops / lgm_ms / 1e9,
        "tflops_s_tf32": lgm_flops / lgm_tf32_ms / 1e9,
        "scale_min": float(scale.min()), "scale_mean": float(scale.mean()),
        "scale_max": float(scale.max()),
        "opacity_mean": float(splat.opacity.mean()),
        "xyz_clamped_share": float((splat.xyz.abs() == 1).float().mean()),
        "ply_bytes": os.path.getsize(ply)}
    log(f"mvdream_lgm c. forward_gaussians: {rec['forward_gaussians']}")
    rec["c_s"] = time.perf_counter() - t0

    # d. gs_to_mesh's 24-view supervision orbit through K1′
    t0 = time.perf_counter()
    cams = orbit_cameras(g2m_cfg, device=dev)
    kw = dict(background=(1.0, 1.0, 1.0), backend="flat")
    torch.cuda.synchronize()
    reset_launches()
    out = G.render(splat, cams, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches, "flat", GS_ORBIT_VIEWS, 0, "24-view orbit")
    img = out["image"]
    check(tuple(img.shape) == (GS_ORBIT_VIEWS, orbit_size, orbit_size, 3),
          f"orbit image {tuple(img.shape)}")
    check(all(bool(torch.isfinite(out[k]).all())
              for k in ("image", "alpha", "depth")), "non-finite orbit")
    orbit_ms = cuda_ms(lambda: G.render(splat, cams, **kw), 3, warmup=1)
    cam0 = Camera(c2w=cams.c2w[0], fovy_deg=cams.fovy_deg[0],
                  width=orbit_size, height=orbit_size, near=cams.near,
                  far=cams.far)
    inp = flat_inputs(splat, cam0)
    cmp, (_, _, stops), plain_img = kernel_vs_plain("mvdream_lgm_view0",
                                                    inp, True)
    view0_db = psnr(img[0], plain_img)
    check(view0_db >= TOL_PSNR_DB,
          f"orbit view 0 vs the plain compositor: {view0_db:.2f} dB")
    box = flat_box_stats(inp, stops)
    check_box(box, "orbit view 0")
    bound = flat_fwd_bound(inp, stops, box)
    kargs, _ = flat_kernel_args(inp, True)
    k_ms = cuda_ms(lambda: gs_flat.composite_bins_fwd_rows(*kargs), 20)
    p_ms = cuda_ms(lambda: gs_flat.composite_bins_fwd_rows_plain(*kargs), 5,
                   warmup=1)
    rec["orbit"] = {
        "views": GS_ORBIT_VIEWS, "size": orbit_size,
        "radius": g2m_cfg.radius, "fovy": g2m_cfg.fovy_deg,
        "launches": launches, "ms": orbit_ms,
        "ms_per_view": orbit_ms / GS_ORBIT_VIEWS,
        "overflow_views": int(out["overflow"].sum()),
        "mean_alpha": float(out["alpha"].mean()),
        "view0": dict(cmp, view_vs_plain_psnr_db=view0_db,
                      kernel_ms=k_ms, plain_ms=p_ms, box=box, bound=bound,
                      **coarse_overflow(inp))}
    log(f"mvdream_lgm d. the 24-view orbit: {rec['orbit']}")
    del inp, out, img

    # text → 24 views, end to end, on the host's clock
    torch.cuda.synchronize()
    te = time.perf_counter()
    G.render(lgm.forward_gaussians(text_to_views()), cams, **kw)
    torch.cuda.synchronize()
    rec["text_to_orbit_s"] = time.perf_counter() - te
    log(f"mvdream_lgm: text → 24 views in {rec['text_to_orbit_s']:.3f} s")
    rec["d_s"] = time.perf_counter() - t0

    # phase 19d's graph runs text → splats with these weights and compares
    return rec, splat


# ------------------------------------------------------------------ #
# The GS→mesh converter (phase 15)
# ------------------------------------------------------------------ #
TOL_G2M_REL = 1e-3       # card vs CPU, of the largest value, TF32 off
TOL_UV_IDS = 0.999       # UV rasterization: texels whose face ids agree
TOL_BAKE = 1e-4          # baked albedo, card vs CPU, where the ids agree
LOSS_DROP_NGP = 0.5      # the fit's last reported loss < 0.5 × its first
SHELL_SPLATS = 20_000    # the structured scene: a coloured shell of splats
SHELL_RADIUS = 0.5
SHELL_SCALE = 0.02
# per splat: about 16 splats' Gaussian weight covers each point of the
# wall, so a wall passes about 30 % of the light and the fit sees the
# shell's inside (an opaque shell's inside, seen by no ray, fills at
# σ ≈ 8-9, just under the threshold of 10, and its surface is foam:
# `chip_gs_to_mesh_scenes.py`)
SHELL_OPACITY = 0.076
SMALL_GRID = dict(num_levels=4, log2_table_size=12)
SMALL_NGP = dict(ray_batch=1024, num_steps=32, hidden=16, iterations=5)
# 15b's fit iterations (GSToMeshConfig()'s 384, cut to keep the script's
# time: the widths stay); 15c keeps every default
G2M_ITERS = 128


def shell_splat(device, n=SHELL_SPLATS, seed=0, opacity=SHELL_OPACITY,
                filled=False):
    """n splats on (or, when `filled`, inside) a sphere of radius 0.5,
    directions from a seed, each coloured by its direction, isotropic
    scale 0.02, of the given opacity."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.gaussian import GaussianSplat
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = rng.rand(n, 1) ** (1.0 / 3.0) * SHELL_RADIUS if filled \
        else SHELL_RADIUS
    s = GaussianSplat.from_points((d * r).astype(np.float32),
                                  colors=(0.5 + 0.45 * d).astype(np.float32),
                                  initial_scale=SHELL_SCALE, device=device)
    return dataclasses.replace(s, opacity_raw=torch.full_like(
        s.opacity_raw, math.log(opacity / (1.0 - opacity))))


def gs_to_mesh_path(dev, asset_dir, smi_line):
    """Phase 15: `algorithms/gs_to_mesh.py::convert` at `GSToMeshConfig()`
    (24 views at 256², 384 iterations, `NGPConfig()` widths, 192³, σ 10,
    100k faces, 1024²); text → phase 14's splats → mesh at those defaults
    but `G2M_ITERS` NeRF iterations runs as phase 19d's graph."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.algorithms import gs_to_mesh as g2m
    from comfy3d_tpu_torch.algorithms import ngp
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.ops import gs_flat, hashgrid, tetra, texture
    from comfy3d_tpu_torch.ops import gs_render as G
    from comfy3d_tpu_torch.ops import uv_atlas

    cfg = g2m.GSToMeshConfig()
    shell_cfg = dataclasses.replace(cfg, ngp_iters=G2M_ITERS)
    rec = {"card": smi_line, "config": dataclasses.asdict(cfg),
           "shell_ngp_iters": G2M_ITERS,
           "ngp_config": dataclasses.asdict(ngp.NGPConfig(
               iterations=cfg.ngp_iters)), "seed": 0}
    cpu = torch.device("cpu")

    # a. the card against the CPU at small widths, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    gcfg = hashgrid.HashGridConfig(**SMALL_GRID)
    ncfg = ngp.NGPConfig(grid=gcfg, **SMALL_NGP)
    rng = np.random.RandomState(0)
    table = (rng.rand(gcfg.num_levels, gcfg.table_size,
                      gcfg.features_per_level) - 0.5).astype(np.float32)
    x = rng.rand(65536, 3).astype(np.float32)
    cot = rng.randn(65536, gcfg.output_dim).astype(np.float32)
    enc = {}
    for d in (cpu, dev):
        t = torch.tensor(table, device=d, requires_grad=True)
        e = hashgrid.encode(t, torch.as_tensor(x, device=d), gcfg)
        (e * torch.as_tensor(cot, device=d)).sum().backward()
        enc[d.type] = (e.detach(), t.grad)
    parity = {"encode_rel_err": rel_err(enc[dev.type][0], enc["cpu"][0]),
              "table_grad_rel_err": rel_err(enc[dev.type][1], enc["cpu"][1])}
    small = dataclasses.replace(cfg, n_views=6, render_size=32)
    cams = g2m.orbit_cameras(small, device=cpu)
    imgs = rng.rand(6, 32, 32, 3).astype(np.float32)
    masks = (rng.rand(6, 32, 32) > 0.5).astype(np.float32)
    init = ngp.init_params(ncfg, torch.Generator().manual_seed(0),
                           device=cpu)
    fits, losses = {}, {}
    for d in (cpu, dev):
        run = ngp.NGPFit(cams, imgs, masks, ncfg,
                         init=copy.deepcopy(init), device=d)
        if d == cpu:
            draws = [run.draw(it) for it in range(ncfg.iterations)]
        losses[d.type] = []
        for it in range(ncfg.iterations):
            losses[d.type].append(float(run.step(draws[it])))
            run.occ_step(draws[it]["occ"])
        fits[d.type] = run
    parity["fit_loss_rel_err"] = max(abs(a - b) / abs(b) for a, b in zip(
        losses[dev.type], losses["cpu"]))
    # one field (the CPU's fit) sampled on each device
    shared_field = {"cpu": fits["cpu"].field,
                    dev.type: copy.deepcopy(fits["cpu"].field).to(dev)}
    grids = {d: ngp.density_grid(shared_field[d], ncfg, res=48)
             for d in ("cpu", dev.type)}
    parity["density_grid_48_rel_err"] = rel_err(grids[dev.type],
                                                grids["cpu"])
    for k, v in parity.items():
        check(v <= TOL_G2M_REL, f"gs_to_mesh {k}: card vs CPU {v:.3g}")
    # reported, not gated: each device's own fit. Float rounding decides
    # discrete turns of a fit (a cell of the occupancy grid on either side
    # of its threshold, Adam's step on a gradient near its ε), so the two
    # tables drift apart by up to a step of lr per entry while the losses
    # agree
    fitted = {}
    for k, p in fits["cpu"].field.state_dict().items():
        fitted[f"{k}_rel_err"] = rel_err(
            fits[dev.type].field.state_dict()[k], p)
    fitted["occ_rel_err"] = rel_err(fits[dev.type].occ, fits["cpu"].occ)
    fitted["density_grid_48_rel_err"] = rel_err(
        ngp.density_grid(fits[dev.type].field, ncfg, res=48), grids["cpu"])
    parity["own_fits"] = fitted
    # one shared grid, swept on each device
    shared = grids["cpu"]
    iso = float(shared.quantile(0.95))
    meshes = {d.type: tetra.extract_isosurface(shared.to(d), iso=iso,
                                               max_tris=400_000)
              for d in (cpu, dev)}
    a, b = meshes[dev.type], meshes["cpu"]
    check(a.num_faces == b.num_faces > 0 and np.array_equal(a.f, b.f),
          f"extract_isosurface: card {a.num_faces}, CPU {b.num_faces} faces")
    parity["extract_faces"] = a.num_faces
    parity["extract_v_max_abs_err"] = float(np.abs(a.v - b.v).max())
    check(parity["extract_v_max_abs_err"] <= TOL_MESH_V,
          f"extract vertices {parity['extract_v_max_abs_err']:.3g}")
    # one shared mesh and UV layout, rasterized and baked at 256²
    sphere = tetra.extract_isosurface(
        sphere_density(ngp.grid_points(41, 1.0, cpu)).reshape(41, 41, 41),
        iso=0.0)
    vt, ft = uv_atlas.atlas_unwrap(sphere.v, sphere.f)
    uv, tex = {}, {}
    for d in (cpu, dev):
        uv[d.type] = texture.rasterize_uv(vt, ft, 256, device=d)
        field = fits["cpu"].field if d == cpu else \
            copy.deepcopy(fits["cpu"].field).to(d)

        def color_fn(p, field=field):
            return field.field(p, -p / torch.linalg.vector_norm(
                p, dim=-1, keepdim=True).clamp_min(1e-8))[1]

        tex[d.type] = texture.bake_color_fn(sphere.v, sphere.f, vt, ft,
                                            color_fn, texture_size=256,
                                            device=d).cpu()
    ids_c, ids_h = uv[dev.type].face_id.cpu(), uv["cpu"].face_id
    same = ids_c == ids_h
    parity["uv_faces"] = sphere.num_faces
    parity["uv_covered_share"] = float((ids_h >= 0).float().mean())
    parity["uv_face_id_agree_share"] = float(same.float().mean())
    covered = torch.flip(same & (ids_h >= 0), (0,))
    parity["bake_max_abs_err"] = float(
        (tex[dev.type] - tex["cpu"]).abs()[covered].max())
    check(parity["uv_face_id_agree_share"] >= TOL_UV_IDS,
          f"UV face ids agree on {parity['uv_face_id_agree_share']:.5f}")
    check(parity["bake_max_abs_err"] <= TOL_BAKE,
          f"bake_color_fn: card vs CPU {parity['bake_max_abs_err']:.3g}")
    log(f"gs_to_mesh a. card vs CPU (small widths, TF32 off): {parity}")
    rec["card_vs_cpu"] = parity
    del enc, fits, shared_field, grids, meshes, uv, tex
    rec["a_s"] = time.perf_counter() - t0

    # b. a structured scene at the node's defaults
    t0 = time.perf_counter()
    shell = shell_splat(dev)
    losses, info = [], {}
    torch.cuda.synchronize()
    reset_launches()
    tb = time.perf_counter()
    mesh = g2m.convert(shell, shell_cfg, progress=lambda it, m:
                       losses.append((it, m["loss"])), info=info)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - tb
    launches = read_launches()
    expect_launches(launches, "flat", cfg.n_views, 0, "gs_to_mesh convert")
    first, last = losses[0][1], losses[-1][1]
    check(last < LOSS_DROP_NGP * first,
          f"the fit's loss {first:.4g} → {last:.4g} did not halve")
    check(0 < mesh.num_faces <= cfg.decimate_target,
          f"{mesh.num_faces} faces")
    radius = float(np.linalg.norm(mesh.v, axis=1).mean())
    check(abs(radius - SHELL_RADIUS) <= 0.1, f"mean vertex radius {radius}")
    check(mesh.albedo is not None and mesh.albedo.shape == (
        cfg.texture_size, cfg.texture_size, 3), "no albedo")
    check(bool(np.isfinite(mesh.albedo).all()) and mesh.albedo.min() >= 0
          and mesh.albedo.max() <= 1, "albedo outside [0, 1]")
    glb = os.path.join(asset_dir, "gs_to_mesh_shell.glb")
    mesh.write(glb)
    back = Mesh.load(glb)
    check(np.array_equal(back.v[back.f], mesh.v[mesh.f])
          and np.allclose(back.vt[back.ft], mesh.vt[mesh.ft], atol=1e-7,
                          rtol=0)
          and np.abs(back.albedo - mesh.albedo).max() <= 1.0 / 255,
          "GLB round trip changed the mesh")
    # K1′ on view 0 of the supervision orbit, against its plain version
    cams = g2m.orbit_cameras(cfg, device=dev)
    cam0 = Camera(c2w=cams.c2w[0], fovy_deg=cams.fovy_deg[0],
                  width=cfg.render_size, height=cfg.render_size,
                  near=cams.near, far=cams.far)
    inp = flat_inputs(shell, cam0)
    cmp, (_, _, stops), _ = kernel_vs_plain("gs_to_mesh_view0", inp, True)
    box = flat_box_stats(inp, stops)
    check_box(box, "gs_to_mesh view 0")
    kargs, _ = flat_kernel_args(inp, True)
    view0 = dict(cmp, box=box, bound=flat_fwd_bound(inp, stops, box),
                 kernel_ms=cuda_ms(
                     lambda: gs_flat.composite_bins_fwd_rows(*kargs), 20),
                 plain_ms=cuda_ms(
                     lambda: gs_flat.composite_bins_fwd_rows_plain(*kargs),
                     5, warmup=1), **coarse_overflow(inp))
    del inp, kargs
    rec["shell"] = {
        "splats": SHELL_SPLATS, "radius": SHELL_RADIUS,
        "scale": SHELL_SCALE, "opacity": SHELL_OPACITY,
        "ngp_iters": G2M_ITERS,
        "launches": launches, "convert_s": convert_s, "losses": losses,
        "nv": mesh.num_vertices, "nf": mesh.num_faces, "info": info,
        "mean_vertex_radius": radius,
        "albedo_mean": float(mesh.albedo.mean()),
        "glb_bytes": os.path.getsize(glb), "view0": view0}
    log(f"gs_to_mesh b. shell at the defaults: {rec['shell']}")
    del mesh, back
    rec["b_s"] = time.perf_counter() - t0

    # d. one NeRF step at full width, profiled (c., text → LGM's splats →
    # mesh, is phase 19d's graph)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = G.render(shell, cams, background=(1.0, 1.0, 1.0))
    run = ngp.NGPFit(cams, out["image"], (out["alpha"] > 0.5).float(),
                     ngp.NGPConfig(iterations=cfg.ngp_iters), device=dev)
    draws = [run.draw(it) for it in range(4)]
    for it in range(3):                                   # warm-up
        run.step(draws[it])
    step_ms = cuda_ms(lambda: run.step(draws[3]), 10, warmup=1)
    prof = profile_frames(lambda: run.step(draws[3]), 3)
    prof["device_idle_share"] = 1.0 - prof["device_union_ms"] \
        / prof["window_ms"]
    gather_ms = prof["index_select_ms"]
    n = run.cfg.ray_batch * run.cfg.num_steps
    rec["nerf_step"] = {
        "samples": n, "gathered_rows": n * run.cfg.grid.num_levels * 8,
        "ms": step_ms, "hashgrid_gather_ms": gather_ms,
        "hashgrid_scatter_ms": prof["index_add_ms"],
        "hashgrid_share": (gather_ms + prof["index_add_ms"])
        / prof["device_busy_ms"],
        "profile": {k: v for k, v in prof.items() if k != "top"},
        "top": prof["top"]}
    log(f"gs_to_mesh d. one NeRF step at full width: {rec['nerf_step']}")
    del run, draws, shell
    torch.cuda.empty_cache()
    rec["d_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------------ #
# Zero123Plus image → grid → six views → InstantMesh → mesh (phase 16)
# ------------------------------------------------------------------ #
TOL_Z123_REL = 1e-3      # card vs CPU, of the largest value, TF32 off
Z123_STEPS = 28          # the Zero123Plus_Diffusion_Model node's defaults
Z123_GUIDANCE = 4.0
Z123_SEED = 1234
# parameters of Zero123PlusConfig()'s UNet and VAE and of CLIP at
# CLIPVisionConfig() widths with projection_dim 1024 (the JAX package's
# `jax.eval_shape` counts; `tests/test_torch_zero123plus.py`)
Z123_PARAMS = {"unet": 865_910_724, "vae": 83_653_863, "clip": 304_228_352}
Z123_CLIP_PROJ = 1024
# 16a's cut: one resnet per block, 2 CLIP layers, a 192×128 canvas and a
# 128² condition image (the widths kept)
Z123_SMALL = dict(height=192, width=128, cond_size=128)
Z123_SMALL_CLIP_LAYERS = 2
SAMPLER_STEPS = 3        # 16a: loop steps of each sampler, card vs CPU
# kernels of `F.scaled_dot_product_attention` by name: flash, the
# memory-efficient (CUTLASS fmha), cuDNN's; a math fallback shows as
# softmax kernels between GEMMs
SDPA_KERNELS = ("flash", "fmha", "efficient_attention", "sdpa",
                "attention", "softmax")


def clip_encoder(seed, cfg, device):
    """A CLIP vision encoder with weights from `seed`: the JAX package's
    scheme (`common.init_weights_`) for its linear, conv and norm layers,
    the class token and positions normal with std 0.02."""
    import torch
    from comfy3d_tpu_torch.models import clip
    from comfy3d_tpu_torch.models.common import init_weights_
    with torch.device("meta"):
        model = clip.CLIPVisionEncoder(cfg)
    model = model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    emb = model.embeddings
    with torch.no_grad():
        for p in (emb.class_embedding, emb.position_embedding.weight):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model.to(device).eval()


def zero123plus_pipe(seed, cfg, clip_cfg, device, host=None):
    """`Zero123PlusPipeline.init_random(seed, cfg)` on `device` (or
    `pipe_on(host, device)` of a pipeline drawn on the CPU) with a seeded
    CLIP vision encoder attached and ramping coefficients seeded in [0, 1]
    (the JAX default's zeros would null the global term)."""
    import numpy as np
    import torch
    from comfy3d_tpu_torch.models import clip
    from comfy3d_tpu_torch.models.zero123plus import Zero123PlusPipeline
    pipe = (Zero123PlusPipeline.init_random(seed, cfg, device=device)
            if host is None else pipe_on(host, device))
    enc = clip_encoder(seed + 1, clip_cfg, device)
    pipe.set_vision_encoder(clip.make_vision_conditioner(enc))
    pipe.ramping = torch.as_tensor(np.random.RandomState(seed).rand(
        cfg.prompt_tokens).astype(np.float32))
    return pipe, enc


def reference_image(size, seed=3):
    """A seeded [1, S, S, 3] image and the disc mask [1, S, S] that the
    node composites on white."""
    import numpy as np
    img = np.random.RandomState(seed).rand(1, size, size, 3).astype(
        np.float32)
    yy, xx = np.mgrid[:size, :size] + 0.5 - size / 2
    mask = ((yy ** 2 + xx ** 2) < (0.4 * size) ** 2)[None].astype(np.float32)
    return img, mask


def z123_draws(cfg, cond_batch, n_loop, seed, device):
    """Seeded noise for `Zero123PlusPipeline.__call__(draws=...)`, drawn
    on the CPU so both devices take the same."""
    import torch
    f = cfg.vae_factor
    lh, lw, cs = cfg.height // f, cfg.width // f, cfg.cond_size // f
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen).to(device)
    return {"latents": draw(1, 4, lh, lw),
            "cond": [draw(cond_batch, 4, cs, cs) for _ in range(n_loop)],
            "step": [draw(1, 4, lh, lw) for _ in range(n_loop)]}


def z123_step(pipe, image, guidance_scale, i=0, steps=Z123_STEPS):
    """The body of `Zero123PlusPipeline.__call__`'s loop at step i, from
    seeded noise: the condition latents re-noised and written, the guided
    batch read, one Euler-ancestral step. Returns the closure."""
    import torch
    from comfy3d_tpu_torch.models.diffusion.schedulers import (
        SchedulerConfig, make_scheduler)
    cfg = pipe.cfg
    sched = make_scheduler("EulerAncestralDiscreteScheduler", SchedulerConfig(
        prediction_type="v_prediction", timestep_spacing="trailing"), steps)
    cond_lat = torch.cat([pipe.encode_condition(torch.zeros_like(image)),
                          pipe.encode_condition(image)])
    states = torch.cat([pipe._f32(pipe.prompt_embeds)[None],
                        pipe._encoder_states(image)])
    d = z123_draws(cfg, 2, 1, 7, pipe.device)
    latents = d["latents"] * sched.init_sigma
    tvec = torch.full((2,), float(sched.timesteps[i]), device=pipe.device)
    unet = pipe.model.unet

    def step():
        noisy = sched.scale_model_input(
            sched.add_noise(cond_lat, d["cond"][0], i), i)
        _, ref = unet(noisy, tvec, states, ref_mode="write")
        out = unet(sched.scale_model_input(torch.cat([latents] * 2), i),
                   tvec, states, ref_mode="read", ref_hidden=ref)
        un, co = out.chunk(2)
        return sched.step(un + guidance_scale * (co - un), i, latents,
                          d["step"][0])
    return step


def sampler_run(name, device, shape, seed=11):
    """SAMPLER_STEPS loop steps of one sampler (v-prediction, trailing)
    from seeded model outputs and noise → the latents, the last step's
    scaled model input and, for KDPM2's pair, `aux` (the held sample)."""
    import torch
    from comfy3d_tpu_torch.models.diffusion.schedulers import (
        SchedulerConfig, make_scheduler)
    sched = make_scheduler(name, SchedulerConfig(
        prediction_type="v_prediction", timestep_spacing="trailing"),
        SAMPLER_STEPS)
    gen = torch.Generator().manual_seed(seed)

    def draw():
        return torch.randn(shape, generator=gen).to(device)
    lat = draw() * sched.init_sigma
    aux = sched.init_aux(lat)
    for i in range(SAMPLER_STEPS):
        x_in = sched.scale_model_input(lat, i)
        out, noise = draw(), draw()
        lat, aux = sched.step_aux(out, i, lat, aux, noise)
    out = {"latents": lat, "model_input": x_in}
    if aux is not None:
        out["aux"] = aux
    return out


def zero123plus_instantmesh_path(dev, asset_dir, smi_line):
    """Phase 16, at `Zero123PlusConfig()` (SD-2.1 widths, a 960×640
    canvas) with a CLIP vision encoder at `CLIPVisionConfig()` widths
    (projection_dim 1024) and `InstantMeshConfig()`, at the nodes'
    defaults (28 Euler-ancestral steps, CFG 4, seed 1234; six 320² views,
    radius 4, fovy 30). Runs under `torch.no_grad()`."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.camera import ORBITPOSE_PRESETS
    from comfy3d_tpu_torch.core.image import (composite_background,
                                              resize_images,
                                              split_image_grid)
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models import clip
    from comfy3d_tpu_torch.models.diffusion.schedulers import SCHEDULERS
    from comfy3d_tpu_torch.models.instantmesh import (
        InstantMeshConfig, InstantMeshPipeline, orbit_poses_to_input_cameras)
    from comfy3d_tpu_torch.models.instantmesh.pipeline import EXTRACT_STAGES
    from comfy3d_tpu_torch.models.zero123plus import (Zero123PlusConfig,
                                                      Zero123PlusPipeline)

    cfg = Zero123PlusConfig()
    clip_cfg = dataclasses.replace(clip.CLIPVisionConfig(),
                                   projection_dim=Z123_CLIP_PROJ)
    im_cfg = InstantMeshConfig()
    node = dict(num_inference_steps=Z123_STEPS,
                guidance_scale=Z123_GUIDANCE, seed=Z123_SEED)
    rec = {"card": smi_line, "node": node,
           "config": dataclasses.asdict(cfg),
           "clip_config": dataclasses.asdict(clip_cfg),
           "instantmesh_config": dataclasses.asdict(im_cfg),
           "prompt_embeds": "zeros", "ramping": "seeded in [0, 1]"}
    cpu = torch.device("cpu")
    poses = [[1.2, e, a, 0.0, 0.0, 0.0]
             for e, a in ORBITPOSE_PRESETS["Zero123Plus(6)"]]
    p = np.asarray(poses, np.float32)
    cams = orbit_poses_to_input_cameras(p[:, 2], p[:, 1], radius=4.0,
                                        fov_deg=30.0)

    # a. the card against the port's CPU path at small widths, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    small = dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, layers_per_block=1),
        vae=dataclasses.replace(cfg.vae, layers_per_block=1), **Z123_SMALL)
    small_clip = dataclasses.replace(clip_cfg, layers=Z123_SMALL_CLIP_LAYERS)
    img_np, mask_np = reference_image(small.cond_size)
    f = small.vae_factor
    lat_shape = (1, 4, small.height // f, small.width // f)
    cs = small.cond_size // f
    rng = np.random.RandomState(5)
    cond_np = rng.randn(2, 4, cs, cs).astype(np.float32)
    lat_np = rng.randn(2, *lat_shape[1:]).astype(np.float32)
    host = Zero123PlusPipeline.init_random(0, small, device=cpu)
    outs = {}
    for d in (cpu, dev):
        th = time.perf_counter()
        pipe, enc = zero123plus_pipe(0, small, small_clip, d, host)
        img = composite_background(torch.as_tensor(img_np, device=d),
                                   torch.as_tensor(mask_np, device=d))
        states = torch.cat([pipe._f32(pipe.prompt_embeds)[None],
                            pipe._encoder_states(img)])
        tvec = torch.full((2,), 999.0, device=d)
        unet = pipe.model.unet
        out_w, written = unet(torch.as_tensor(cond_np, device=d), tvec,
                              states, ref_mode="write")
        o = {"clip": pipe.vision_encoder(img),
             "encode_condition": pipe.encode_condition(img),
             "unet_write": out_w,
             "unet_read": unet(torch.as_tensor(lat_np, device=d), tvec,
                               states, ref_mode="read", ref_hidden=written),
             "two_steps": pipe(img[0], num_inference_steps=2,
                               guidance_scale=Z123_GUIDANCE,
                               draws=z123_draws(small, 2, 2, 9, d))}
        o.update({f"written_{k}": w[0] for k, w in written.items()})
        for name in SCHEDULERS:
            for k, v in sampler_run(name, d, lat_shape).items():
                o[f"{name}_{k}"] = v
        torch.cuda.synchronize()
        outs[d.type] = o
        outs[d.type + "_s"] = time.perf_counter() - th
        del pipe, enc, written
    parity = {"layers_per_block": 1, "clip_layers": Z123_SMALL_CLIP_LAYERS,
              **Z123_SMALL, "written": len([k for k in outs["cpu"]
                                            if k.startswith("written_")]),
              "host_s": outs["cpu_s"], "card_s": outs[dev.type + "_s"]}
    for k, ref in outs["cpu"].items():
        parity[f"{k}_rel_err"] = rel_err(outs[dev.type][k], ref)
    log(f"zero123plus a. card vs CPU (small widths, TF32 off): {parity}")
    for k in outs["cpu"]:
        check(parity[f"{k}_rel_err"] <= TOL_Z123_REL,
              f"zero123plus {k}: card vs CPU {parity[k + '_rel_err']:.3g} "
              f"of the largest value")
    rec["card_vs_cpu"] = parity
    del outs, host
    rec["a_s"] = time.perf_counter() - t0

    # b. full width: image → grid by CUDA events, one step, the VAE, CLIP
    t0 = time.perf_counter()
    pipe, enc = zero123plus_pipe(0, cfg, clip_cfg, dev)
    init_s = time.perf_counter() - t0
    params = {"unet": count_params(pipe.model.unet),
              "vae": count_params(pipe.model.vae), "clip": count_params(enc)}
    check(params == Z123_PARAMS, f"parameters {params}, not {Z123_PARAMS}")
    img_np, mask_np = reference_image(cfg.cond_size)
    image = composite_background(torch.as_tensor(img_np, device=dev),
                                 torch.as_tensor(mask_np, device=dev))

    def image_to_grid():
        return pipe(image[0], **node)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    grid_ms = cuda_ms(image_to_grid, 1, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    grid_tf32_ms = tf32_ms(image_to_grid, 1, warmup=0)
    grid = image_to_grid()
    check(tuple(grid.shape) == (cfg.height, cfg.width, 3),
          f"grid {tuple(grid.shape)}")
    check(bool(torch.isfinite(grid).all()), "non-finite grid")
    check(float(grid.min()) >= 0.0 and float(grid.max()) <= 1.0,
          "grid outside [0, 1]")

    one_step = z123_step(pipe, image, Z123_GUIDANCE)
    step_ms = cuda_ms(one_step, 3, warmup=1)
    step_tf32_ms = tf32_ms(one_step, 3)
    prof = profile_frames(one_step, 2, match=SDPA_KERNELS)
    prof["device_idle_share"] = 1.0 - prof["device_union_ms"] \
        / prof["window_ms"]
    step_flops = flops_of(one_step)
    f = cfg.vae_factor
    z = torch.randn((1, 4, cfg.height // f, cfg.width // f),
                    generator=torch.Generator().manual_seed(8)).to(dev)
    encode_ms = cuda_ms(lambda: pipe.encode_condition(image), 3, warmup=1)
    decode_ms = cuda_ms(lambda: pipe.model.vae.decode(z), 3, warmup=1)
    clip_ms = cuda_ms(lambda: pipe.vision_encoder(image), 3, warmup=1)
    decode_flops = flops_of(lambda: pipe.model.vae.decode(z))
    rec["image_to_grid"] = {
        "ms": grid_ms, "ms_tf32": grid_tf32_ms, "init_s": init_s,
        "peak_bytes": peak, "params": params,
        "weight_bytes": sum(p.numel() * p.element_size()
                            for p in list(pipe.model.parameters())
                            + list(enc.parameters())),
        "clipped_share": float(((grid == 0) | (grid == 1)).float().mean()),
        "mean": float(grid.mean()),
        "step_ms": step_ms, "step_ms_tf32": step_tf32_ms,
        "step_flops": step_flops,
        "step_tflops_s": step_flops / step_ms / 1e9,
        "step_tflops_s_tf32": step_flops / step_tf32_ms / 1e9,
        "step_profile": {k: x for k, x in prof.items()
                         if k not in ("top", "matched")},
        "step_profile_top": prof["top"][:6],
        "sdpa_kernels": prof["matched"],
        "encode_condition_ms": encode_ms, "decode_ms": decode_ms,
        "decode_flops": decode_flops,
        "decode_tflops_s": decode_flops / decode_ms / 1e9,
        "clip_ms": clip_ms}
    log(f"zero123plus b. full width: {rec['image_to_grid']}")
    rec["b_s"] = time.perf_counter() - t0

    # c. image → grid → six views → InstantMesh → mesh, the compositor
    # kernels' launches counted (none may launch)
    t0 = time.perf_counter()
    im = InstantMeshPipeline.init_random(0, im_cfg, device=dev)
    cams_dev = torch.as_tensor(cams, device=dev)

    def image_to_mesh():
        grid = pipe(composite_background(
            torch.as_tensor(img_np, device=dev),
            torch.as_tensor(mask_np, device=dev))[0], **node)
        views = resize_images(split_image_grid(grid, 3, 2), 320, 320)
        planes = im.forward_planes(views[None], cams_dev[None])
        return views, planes, im.extract_mesh(planes[0])

    torch.cuda.synchronize()
    reset_launches()
    te = time.perf_counter()
    views, planes, mesh = image_to_mesh()
    torch.cuda.synchronize()
    image_to_mesh_s = time.perf_counter() - te
    launches = read_launches()
    check(not any(launches.values()),
          f"the Zero123Plus → InstantMesh path launched a compositor "
          f"kernel: {launches}")
    check(tuple(views.shape) == (6, 320, 320, 3), f"views {views.shape}")
    planes_ms = cuda_ms(lambda: im.forward_planes(views[None],
                                                  cams_dev[None]), 3,
                        warmup=1)
    _, extract_s, spans, _ = profile_spans(
        lambda: im.extract_mesh(planes[0]), EXTRACT_STAGES)
    check(all(sp["calls"] == 1 for sp in spans.values()),
          f"extract_mesh's spans: {spans}")
    check(mesh.num_vertices > 0 and mesh.num_faces > 0, "empty mesh")
    check(bool(np.isfinite(mesh.v).all()), "non-finite vertices")
    check(int(mesh.f.max()) < mesh.num_vertices, "faces past the vertices")
    glb = os.path.join(asset_dir, "zero123plus_instantmesh.glb")
    mesh.write(glb)
    back = Mesh.load(glb)
    check(np.array_equal(back.v, mesh.v) and np.array_equal(back.f, mesh.f),
          "GLB round trip changed the mesh")
    res = im_cfg.grid_res + 1
    rec["mesh"] = {
        "launches": launches, "image_to_mesh_s": image_to_mesh_s,
        "forward_planes_ms": planes_ms, "resolution": res,
        "capacity": im._cap_memo[res], "extract_total_s": extract_s,
        "extract_stages": {k.split(".")[-1]: v for k, v in spans.items()},
        "nv": mesh.num_vertices, "nf": mesh.num_faces,
        "glb_bytes": os.path.getsize(glb), "poses": poses}
    log(f"zero123plus c. grid → six views → InstantMesh: {rec['mesh']}")
    rec["c_s"] = time.perf_counter() - t0
    del pipe, enc, im, planes
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------------------ #
# Hunyuan3D-2.1 shape: image → latents → octree grid → mesh (phase 17)
# ------------------------------------------------------------------ #
TOL_HY3D_REL = 1e-3      # card vs CPU, of the largest value, TF32 off
TOL_HY3D_BAND = 1e-5     # 17c: octree vs dense grid near the surface
TOL_HY3D_ALONE = 1e-5    # 17b: the pipeline alone's grid vs the graph's,
#                          of the largest value (the same calls, same card)
HY3D_STEPS = 30          # the Hunyuan3D_21_ShapeGen node's defaults
HY3D_TIMED_STEPS = 10    # 17b's denoise timed alone, f32 and TF32
HY3D_GUIDANCE = 7.5
HY3D_SEED = 1234
HY3D_OCTREE = 256
HY3D_CHUNKS = 65536      # the pipeline's num_chunks default
# parameters of Hunyuan3DShapeConfig()'s DiT, ShapeVAE and DINOv2-giant
# (the JAX package's `jax.eval_shape` counts, `tests/test_torch_hunyuan3d.py`;
# DINOv2 without HF's mask_token, which the JAX model lacks)
HY3D_PARAMS = {"dit": 1_113_274_432, "vae": 214_260_737,
               "cond": 1_136_479_232}
# 17a's cut (the widths kept): DiT blocks, DINOv2 layers, VAE layers, the
# dense decode's and the octree decode's resolutions
HY3D_SMALL = dict(depth=1, depth_single_blocks=2, cond_layers=2,
                  vae_layers=1, dense=16, coarse=8, octree=32)


def white_composite(size):
    """`reference_image(size)` composited on white over its disc, as an
    IMAGE batch [1, S, S, 3] (the ShapeGen and TexGen nodes' input)."""
    img, mask = reference_image(size)
    return (img * mask[..., None] + (1.0 - mask[..., None])).astype(
        "float32")


def hunyuan3d_shape_path(dev, asset_dir, smi_line):
    """Phase 17, at `Hunyuan3DShapeConfig()` (DINOv2-giant at 224², the DiT
    of 16 + 32 blocks at width 1,024 on 3,072 latents, the ShapeVAE of 16
    layers) with the Hunyuan3D_21_ShapeGen node's defaults (seed 1234, 30
    steps, CFG 7.5, octree 256; `num_chunks` 65,536). Runs under
    `torch.no_grad()`. Returns the record and 17c's sphere mesh, which
    phase 18 paints."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models.hunyuan3d import (Hunyuan3DShape,
                                                    Hunyuan3DShapeConfig,
                                                    Hunyuan3DShapePipeline)
    from comfy3d_tpu_torch.models.hunyuan3d.pipeline import SHAPE_STAGES
    from comfy3d_tpu_torch.models.vecset import vae as V
    from comfy3d_tpu_torch.nodes.nodes_hunyuan3d import (CLEAN_SPAN,
                                                         shapegen_image)
    from comfy3d_tpu_torch.ops.tetra import EXTRACT_SPANS

    cfg = Hunyuan3DShapeConfig()
    node = dict(seed=HY3D_SEED, num_steps=HY3D_STEPS,
                guidance_scale=HY3D_GUIDANCE, octree_resolution=HY3D_OCTREE,
                num_chunks=HY3D_CHUNKS)
    rec = {"card": smi_line, "node": node,
           "config": dataclasses.asdict(cfg)}
    cpu = torch.device("cpu")

    # a. the card against the port's CPU path at cut depth, TF32 off; the
    # full config's parameter counts on `meta`
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    with torch.device("meta"):
        meta = Hunyuan3DShape(cfg)
    params = {name: count_params(getattr(meta, name))
              for name in ("dit", "vae", "cond")}
    params["cond"] -= meta.cond.embeddings.mask_token.numel()
    del meta
    check(params == HY3D_PARAMS, f"parameters {params}, not {HY3D_PARAMS}")
    s = HY3D_SMALL
    small = dataclasses.replace(
        cfg, dit=dataclasses.replace(cfg.dit, depth=s["depth"],
                                     depth_single_blocks=s[
                                         "depth_single_blocks"]),
        cond=dataclasses.replace(cfg.cond, layers=s["cond_layers"]),
        vae=dataclasses.replace(cfg.vae, num_decoder_layers=s["vae_layers"]))
    image = shapegen_image(white_composite(cfg.image_size))
    gen = torch.Generator().manual_seed(7)
    noise = torch.randn((1, cfg.vae.num_latents, cfg.vae.embed_dim),
                        generator=gen)
    x_np = torch.randn((2, cfg.vae.num_latents, cfg.vae.embed_dim),
                       generator=gen)
    host = Hunyuan3DShapePipeline.init_random(0, small, device=cpu)
    outs = {}
    for d in (cpu, dev):
        th = time.perf_counter()
        pipe = pipe_on(host, d)
        cond = pipe.encode_cond(image)
        t = torch.full((2,), 0.3, device=d)
        decoded = pipe.model.vae(x_np[:1].to(d) / cfg.vae.scale_factor)
        o = {"encode_cond": cond,
             "dit": pipe.model.dit(x_np.to(d), t, cond),
             "two_steps": pipe.sample_latents(
                 image, num_steps=2, guidance_scale=HY3D_GUIDANCE,
                 noise=noise),
             "vae_transformer": decoded,
             "dense_decode": V.decode_volume(
                 pipe.model.vae.query, decoded,
                 octree_resolution=s["dense"]),
             "octree_decode": V.decode_volume_hierarchical(
                 pipe.model.vae.query, decoded,
                 octree_resolution=s["octree"],
                 coarse_resolution=s["coarse"])}
        torch.cuda.synchronize()
        outs[d.type] = o
        outs[d.type + "_s"] = time.perf_counter() - th
        del pipe
    parity = {**s, "tokens": list(outs["cpu"]["encode_cond"].shape),
              "host_s": outs["cpu_s"], "card_s": outs[dev.type + "_s"]}
    for k, ref in outs["cpu"].items():
        parity[f"{k}_rel_err"] = rel_err(outs[dev.type][k], ref)
    log(f"hunyuan3d a. card vs CPU (cut depth, TF32 off): {parity}")
    for k in outs["cpu"]:
        check(parity[f"{k}_rel_err"] <= TOL_HY3D_REL,
              f"hunyuan3d {k}: card vs CPU {parity[k + '_rel_err']:.3g} "
              f"of the largest value")
    rec["params"] = params
    rec["card_vs_cpu"] = parity
    del outs, decoded, host
    rec["a_s"] = time.perf_counter() - t0

    # b. the node's defaults at full width: the config-5 ShapeGen graph
    # (phase 19e: LoadImage → the loader → Hunyuan3D_21_ShapeGen → Save 3D
    # Mesh) once on the host's clock, split by its nodes', the pipeline's
    # and the cleanup's spans, the compositor kernels' launches counted
    # (none may launch)
    t0 = time.perf_counter()
    levels = int(math.log2(HY3D_OCTREE // 64))
    span_names = (SHAPE_STAGES + ("vecset.decode_volume",)
                  + tuple(f"vecset.decode_level{i}" for i in range(levels))
                  + EXTRACT_SPANS + (CLEAN_SPAN,))
    # the graph's decoded grid, captured for the pipeline-alone gate below
    graph_grid, decode_grid = [], Hunyuan3DShapePipeline.decode_grid

    def captured_grid(self, *a, **kw):
        out = decode_grid(self, *a, **kw)
        graph_grid.append(out.detach().clone())
        return out

    Hunyuan3DShapePipeline.decode_grid = captured_grid
    try:
        res, graph = run_graph("config5_shape", config_graph("5_shape"),
                               spans=span_names, device=dev)
    finally:
        Hunyuan3DShapePipeline.decode_grid = decode_grid
    check(len(graph_grid) == 1, f"the graph decoded {len(graph_grid)} grids")
    launches = graph["launches"]
    check(not any(launches.values()),
          f"the Hunyuan3D shape path launched a compositor kernel: "
          f"{launches}")
    clean, processed = res[3]
    check(clean.num_vertices > 0 and clean.num_faces > 0, "empty mesh")
    check(bool(np.isfinite(clean.v).all()), "non-finite vertices")
    check(int(clean.f.max()) < clean.num_vertices, "faces past the vertices")
    check(all(graph["spans"][n]["calls"] == 1
              for n in SHAPE_STAGES + (CLEAN_SPAN,)),
          f"the pipeline's and the cleanup's spans: {graph['spans']}")
    glb = res[4][0]
    back = Mesh.load(glb)
    check(np.array_equal(back.v, clean.v) and np.array_equal(back.f, clean.f),
          "GLB round trip changed the mesh")
    image = processed[0].numpy()
    pipe = res[2][0]
    spans = graph["spans"]
    k_lvl = [min((64 << i) ** 3, max(4096, 14 * (64 << i) ** 2))
             for i in range(levels)]
    points = {"vecset.decode_volume": 65 ** 3,
              **{f"vecset.decode_level{i}": 27 * k
                 for i, k in enumerate(k_lvl)}}
    for name, n in points.items():
        spans[name]["points"] = n
    rec["points_total"] = sum(points.values())
    rec["points_dense_257"] = 257 ** 3
    del res, back
    torch.cuda.empty_cache()

    # the pipeline alone (the loader node's: seed 0, drawn on the card) on
    # the node's processed image, as `pipe(image, **node)` runs it, stage
    # by stage on the host's clock with each stage's peak memory, as far as
    # the decoded grid, which must be the graph's (the graph's spans time
    # the extraction and the cleanup)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stages, peaks = {}, {}

    def stage(name, fn):
        torch.cuda.reset_peak_memory_stats()
        ts = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - ts
        peaks[name] = torch.cuda.max_memory_allocated()
        return out

    lat = stage("sample_latents", lambda: pipe.sample_latents(
        image, node["seed"], node["num_steps"], node["guidance_scale"]))
    grid = stage("decode_grid", lambda: pipe.decode_grid(
        lat, node["octree_resolution"], num_chunks=node["num_chunks"]))
    check(bool(torch.isfinite(grid).all()), "non-finite grid")
    grid_stats = {"inside_share": float((grid > 0).float().mean()),
                  "min": float(grid.min()), "max": float(grid.max())}
    vs_graph = {"same_shape": grid.shape == graph_grid[0].shape}
    check(vs_graph["same_shape"], f"the pipeline alone decoded "
          f"{tuple(grid.shape)}, the graph {tuple(graph_grid[0].shape)}")
    vs_graph.update(
        max_abs=float((grid - graph_grid[0]).abs().max()),
        sign_disagree=int(((grid > 0) != (graph_grid[0] > 0)).sum()))
    check(vs_graph["max_abs"] <= TOL_HY3D_ALONE * float(grid.abs().max()),
          f"the pipeline alone's grid against the graph's: {vs_graph}")
    del grid, graph_grid[:]
    # the 30 steps alone by CUDA events, f32 and TF32; one guided step
    cond = pipe.encode_cond(image)
    noise = torch.randn((1, cfg.vae.num_latents, cfg.vae.embed_dim),
                        generator=torch.Generator().manual_seed(HY3D_SEED)
                        ).to(dev)

    def denoise():
        return pipe.denoise(cond, noise, HY3D_GUIDANCE, HY3D_TIMED_STEPS)

    steps_ms = cuda_ms(denoise, 1, warmup=0)
    steps_tf32_ms = tf32_ms(denoise, 1, warmup=0)
    x2 = torch.cat([noise, noise])
    t2 = torch.full((2,), 0.5, device=dev)

    def one_step():
        return pipe.model.dit(x2, t2, cond)

    step_ms = cuda_ms(one_step, 3, warmup=1)
    step_tf32_ms = tf32_ms(one_step, 3)
    prof = profile_frames(one_step, 2, match=SDPA_KERNELS)
    prof["device_idle_share"] = 1.0 - prof["device_union_ms"] \
        / prof["window_ms"]
    step_flops = flops_of(one_step)
    encode_ms = cuda_ms(lambda: pipe.encode_cond(image), 3, warmup=1)
    # the VAE's transformer on latents of the sampler's shape
    vae_ms = cuda_ms(lambda: pipe.model.vae(noise), 3, warmup=1)
    # one decode chunk of 65,536 points: its SDPA kernel and FLOPs
    decoded = pipe.model.vae(noise)
    pts = (torch.rand((1, HY3D_CHUNKS, 3), generator=torch.Generator()
                      .manual_seed(9)) * 2.02 - 1.01).to(dev)

    def one_chunk():
        return pipe.model.vae.query(decoded, pts)

    chunk_ms = cuda_ms(one_chunk, 3, warmup=1)
    chunk_prof = profile_frames(one_chunk, 3, match=SDPA_KERNELS)
    chunk_flops = flops_of(one_chunk)
    rec["image_to_mesh"] = {
        "image": WF_IMAGE,
        "image_to_mesh_s": graph["s"],
        "stages_s": {k: v["host_ms"] / 1e3 for k, v in spans.items()},
        "alone_stages_s": stages, "stage_peak_bytes": peaks,
        "grid": grid_stats, "alone_vs_graph": vs_graph,
        "peak_bytes": graph["peak_bytes"], "launches": launches,
        "weight_bytes": sum(p.numel() * p.element_size()
                            for p in pipe.model.parameters()),
        "profiled_s": graph["s"], "spans": spans, "graph": graph,
        "nv": clean.num_vertices, "nf": clean.num_faces,
        "glb_bytes": os.path.getsize(glb),
        "steps_ms": steps_ms, "steps_ms_tf32": steps_tf32_ms,
        "timed_steps": HY3D_TIMED_STEPS,
        "step_ms": step_ms, "step_ms_tf32": step_tf32_ms,
        "step_flops": step_flops,
        "step_tflops_s": step_flops / step_ms / 1e9,
        "step_tflops_s_tf32": step_flops / step_tf32_ms / 1e9,
        "step_profile": {k: x for k, x in prof.items()
                         if k not in ("top", "matched")},
        "step_profile_top": prof["top"][:6],
        "sdpa_kernels": prof["matched"],
        "encode_cond_ms": encode_ms, "vae_transformer_ms": vae_ms,
        "decode_chunk_ms": chunk_ms, "decode_chunk_flops": chunk_flops,
        "decode_chunk_tflops_s": chunk_flops / chunk_ms / 1e9,
        "decode_chunk_top": chunk_prof["top"][:6],
        "decode_chunk_sdpa": chunk_prof["matched"]}
    log(f"hunyuan3d b. the node's defaults: {rec['image_to_mesh']}")
    del pipe, cond, noise, decoded, x2, clean, lat
    torch.cuda.empty_cache()
    rec["b_s"] = time.perf_counter() - t0

    # c. the octree decode on the card: an analytic sphere at 256 from 64
    # against the dense 257³ grid
    t0 = time.perf_counter()
    calls = {"points": 0}

    def sphere(decoded, pts):
        calls["points"] += pts.shape[0] * pts.shape[1]
        return sphere_density(pts)

    zeros = torch.zeros((1, 4, 8), device=dev)
    dense = V.decode_volume(sphere, zeros, octree_resolution=HY3D_OCTREE,
                            bounds=1.0, num_chunks=HY3D_CHUNKS)
    calls["points"] = 0
    hier = V.decode_volume_hierarchical(
        sphere, zeros, octree_resolution=HY3D_OCTREE, coarse_resolution=64,
        bounds=1.0, num_chunks=HY3D_CHUNKS)
    band = dense.abs() < 0.04
    far = dense.abs() > 0.2
    band_err = float((hier - dense)[band].abs().max())
    far_agree = float((hier[far].sign() == dense[far].sign()).float().mean())
    sm = V.grid_to_mesh(hier[0], bounds=1.0)
    radius = np.linalg.norm(sm.v, axis=-1)
    rec["octree_sphere"] = {
        "band_points": int(band.sum()), "band_max_abs_err": band_err,
        "far_sign_agreement": far_agree, "queries": calls["points"],
        "query_share": calls["points"] / (HY3D_OCTREE + 1) ** 3,
        "nv": sm.num_vertices, "nf": sm.num_faces,
        "radius_max_dev": float(np.abs(radius - 0.5).max())}
    log(f"hunyuan3d c. octree vs dense sphere: {rec['octree_sphere']}")
    o = rec["octree_sphere"]
    check(band_err <= TOL_HY3D_BAND,
          f"octree vs dense near the surface: {band_err:.3g}")
    check(far_agree >= 0.999, f"far-field signs agree on {far_agree:.5f}")
    check(o["query_share"] < 0.6, f"{o['queries']} queries, not < 0.6 × "
          f"{HY3D_OCTREE + 1}³")
    check(o["radius_max_dev"] <= 0.03,
          f"sphere vertices {o['radius_max_dev']:.4f} off radius 0.5")
    rec["c_s"] = time.perf_counter() - t0
    return rec, sm


# ------------------------------------------------------------------ #
# Hunyuan3D-2.1 paint: mesh + image → six views → PBR textures (phase 18)
# ------------------------------------------------------------------ #
PAINT_STEPS = 8          # the Turbo default of Load_Hunyuan3D_21_TexGen_Pipeline
PAINT_GUIDANCE = 3.0     # Hunyuan3DPaintPipeline.__call__'s defaults
PAINT_SEED = 0
PAINT_PBR = ("albedo", "mr")
PAINT_REMESH_FACES = 40_000   # the Hunyuan3D_21_TexGen node's use_remesh
# parameters of PaintConfig(pbr_settings=PAINT_PBR) (the JAX package's
# `jax.eval_shape` counts, `tests/test_torch_hunyuan3d_paint.py`): the
# generation UNet (of which its 2.5D attentions), the dual UNet, the VAE,
# the camera table and the learned tokens (gen, ref, albedo, mr)
PAINT_PARAMS = {"unet": 965_081_924, "unet_multiview_refview": 99_148_160,
                "unet_dual": 865_910_724, "vae": 83_653_863,
                "class_embedding": 62_720, "tokens": 315_392}
# 18a's cut (the widths kept): one resnet per block in the UNets and the
# VAE, 128² views (16² latents), 256² textures, the mesh decimated further
PAINT_SMALL = dict(layers_per_block=1, render_size=128, texture_size=256,
                   faces=2_000)
# 18c: the bake of the mesh's own position maps must give back v·0.5 + 0.5
TOL_BAKE_MEAN = 0.005
TOL_BAKE_P99 = 0.03
BAKE_SEEN_SHARE = 0.99


def paint_params(model):
    """The parts of a `Hunyuan3DPaint`'s parameters as `PAINT_PARAMS` names
    them."""
    unet = model.unet
    cls = unet.class_embedding.weight.numel()
    tokens = sum(p.numel() for p in unet.parameters(recurse=False))
    return {"unet": count_params(unet) - cls - tokens,
            "unet_multiview_refview": sum(
                p.numel() for k, p in unet.named_parameters()
                if ".attn_multiview." in k or ".attn_refview." in k),
            "unet_dual": count_params(model.unet_dual),
            "vae": count_params(model.vae), "class_embedding": cls,
            "tokens": tokens}


def err_stats(err):
    """Mean, 99th percentile and max of |err| (a CPU tensor)."""
    import torch
    e = err.abs().flatten().double()
    return {"mean": float(e.mean()), "p99": float(torch.quantile(e, 0.99)),
            "max": float(e.max())}


def tex_stats(t):
    import numpy as np
    t = np.asarray(t)
    return {"shape": list(t.shape), "mean": float(t.mean()),
            "std": float(t.std()), "min": float(t.min()),
            "max": float(t.max())}


def hunyuan3d_paint_path(dev, asset_dir, smi_line, shape_mesh):
    """Phase 18, at `PaintConfig(pbr_settings=("albedo", "mr"))` (the
    Load_Hunyuan3D_21_TexGen_Pipeline node's: SD-2.1 widths, six 512²
    views, 1024² textures; weights from seed 0) with the Hunyuan3D_21_TexGen
    node's defaults (8 steps, CFG 3.0, seed 0, the remesh to 40,000 faces)
    on `shape_mesh`, phase 17c's octree sphere. Runs under
    `torch.no_grad()`."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.algorithms import color_project as CP
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models.diffusion.schedulers import make_scheduler
    from comfy3d_tpu_torch.models.hunyuan3d import (Hunyuan3DPaint,
                                                    Hunyuan3DPaintPipeline,
                                                    PaintConfig)
    from comfy3d_tpu_torch.models.hunyuan3d.paint import PAINT_STAGES
    from comfy3d_tpu_torch.nodes import base
    from comfy3d_tpu_torch.nodes.nodes_io import read_image
    from comfy3d_tpu_torch.nodes.nodes_texture import texgen_remesh
    from comfy3d_tpu_torch.ops import rasterize as R

    cfg = PaintConfig(pbr_settings=PAINT_PBR)
    node = dict(num_steps=PAINT_STEPS, guidance_scale=PAINT_GUIDANCE,
                seed=PAINT_SEED)
    rec = {"card": smi_line, "node": node,
           "config": dataclasses.asdict(cfg)}
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    mesh = texgen_remesh(shape_mesh, PAINT_REMESH_FACES)
    rec["mesh"] = {"shape_nf": shape_mesh.num_faces,
                   "nv": mesh.num_vertices, "nf": mesh.num_faces,
                   "remesh_s": time.perf_counter() - t0}
    check(0 < mesh.num_faces <= PAINT_REMESH_FACES,
          f"remesh gave {mesh.num_faces} faces")

    # a. the card against the port's CPU path at cut depth, TF32 off; the
    # full config's parameter counts on `meta`
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    with torch.device("meta"):
        meta = Hunyuan3DPaint(cfg)
    params = paint_params(meta)
    del meta
    check(params == PAINT_PARAMS, f"parameters {params}, not {PAINT_PARAMS}")
    s = PAINT_SMALL
    small = dataclasses.replace(
        cfg, render_size=s["render_size"], texture_size=s["texture_size"],
        unet=dataclasses.replace(cfg.unet,
                                 layers_per_block=s["layers_per_block"]),
        vae=dataclasses.replace(cfg.vae,
                                layers_per_block=s["layers_per_block"]))
    small_mesh = texgen_remesh(mesh, s["faces"])
    lat = small.render_size // small.vae_factor
    rows = len(PAINT_PBR) * small.num_views
    gen = torch.Generator().manual_seed(11)

    def draw(*shape):
        return torch.randn(shape, generator=gen)
    x, img_lat, geom_lat = (draw(rows, 12, lat, lat), draw(1, 4, lat, lat),
                            draw(small.num_views, 8, lat, lat))
    images = torch.rand((3, small.render_size, small.render_size, 3),
                        generator=gen)
    views = torch.rand((small.num_views, small.render_size,
                        small.render_size, 3), generator=gen)
    draws = {"latents": draw(rows, 4, lat, lat),
             "step": [draw(rows, 4, lat, lat)]}
    t_a = time.perf_counter()
    host = Hunyuan3DPaintPipeline.init_random(0, small, device=cpu)
    init_small_s = time.perf_counter() - t_a
    outs = {}
    for d in (cpu, dev):
        th = time.perf_counter()
        pipe = pipe_on(host, d)
        unet = pipe.model.unet
        ref = pipe.write_reference(img_lat.to(d))
        cls, ctx_u, ctx_c = pipe.conditioning()
        t = torch.full((rows,), 601.0, device=d)
        o = {f"write_{k}": w[0] for k, w in ref.items()}
        o["uncond"] = unet(x.to(d), t, ctx_u, class_emb=cls)
        o["cond"] = unet(x.to(d), t, ctx_c, class_emb=cls, ref_mode="read",
                         ref_hidden=ref)
        o["guided_step"] = pipe.denoise(geom_lat.to(d), img_lat.to(d), 1,
                                        PAINT_GUIDANCE, draws=draws)
        o["vae_encode"] = pipe.encode(images)
        o["vae_decode"] = pipe.decode(x[:2, :4].to(d))
        cams = pipe.cameras()
        o["project_colors"], o["project_confidence"] = CP.project_colors(
            small_mesh, views, cams, small.bake_exp,
            view_weights=small.view_weights, device=d)
        o["bake_projection"] = torch.as_tensor(CP.bake_projection(
            small_mesh, views, cams, texture_size=small.texture_size,
            cos_power=small.bake_exp, view_weights=small.view_weights,
            device=d).albedo)
        torch.cuda.synchronize()
        outs[d.type] = o
        outs[d.type + "_s"] = time.perf_counter() - th
        del pipe, ref
    del host
    parity = {**s, "rows": rows, "latent": lat, "init_s": init_small_s,
              "written": len([k for k in outs["cpu"]
                              if k.startswith("write_")]),
              "host_s": outs["cpu_s"], "card_s": outs[dev.type + "_s"]}
    for k, ref in outs["cpu"].items():
        parity[f"{k}_rel_err"] = rel_err(outs[dev.type][k], ref)
    log(f"hunyuan3d paint a. card vs CPU (cut depth, TF32 off): {parity}")
    for k in outs["cpu"]:
        check(parity[f"{k}_rel_err"] <= TOL_HY3D_REL,
              f"hunyuan3d paint {k}: card vs CPU "
              f"{parity[k + '_rel_err']:.3g} of the largest value")
    rec["params"] = params
    rec["card_vs_cpu"] = parity
    del outs
    rec["a_s"] = time.perf_counter() - t0

    # b. the node's defaults at full width: the config-5 TexGen graph
    # (phase 19e: LoadImage, Load 3D Mesh of the sphere → the loader →
    # Hunyuan3D_21_TexGen with `use_remesh` and `create_pbr` → Save 3D Mesh)
    # once on the host's clock, split by its nodes' and the pipeline's
    # spans, the compositor kernels' launches counted (none may launch)
    t0 = time.perf_counter()
    shape_mesh.write(os.path.join(base.INPUT_ROOT_PATH, "hy3d_sphere.glb"))
    res, graph = run_graph(
        "config5_texgen", config_graph("5_texgen", sphere="hy3d_sphere.glb"),
        spans=PAINT_STAGES + CP.BAKE_SPANS, device=dev)
    out, call_s, spans = res[4][0], graph["s"], graph["spans"]
    launches, peak = graph["launches"], graph["peak_bytes"]
    check(not any(launches.values()),
          f"the Hunyuan3D paint path launched a compositor kernel: "
          f"{launches}")
    ts = cfg.texture_size
    for name in ("albedo", "metallic_roughness"):
        tex = getattr(out, name)
        check(tex is not None and tex.shape == (ts, ts, 3),
              f"{name}: {None if tex is None else tex.shape}")
        check(bool(np.isfinite(tex).all()) and tex.min() >= 0.0
              and tex.max() <= 1.0, f"{name} not finite in [0, 1]")
    check(out.vt is not None and out.ft is not None and out.vn is not None,
          "no UVs or normals on the painted mesh")
    check(all(sp["calls"] >= 1 for sp in spans.values()),
          f"spans not entered: {spans}")
    glb = res[5][0]
    back = Mesh.load(glb)
    check(back.metallic_roughness is not None
          and back.metallic_roughness.shape == out.metallic_roughness.shape,
          "GLB round trip lost the metallicRoughness texture")
    check(back.albedo is not None and back.albedo.shape == out.albedo.shape,
          "GLB round trip lost the albedo")
    del res
    # the graph's image, as LoadImage read it
    image = read_image(os.path.join(base.INPUT_ROOT_PATH, "reference.png"))[0]
    torch.cuda.empty_cache()

    # the pipeline alone (the loader node's weights: seed 0, drawn on the
    # card)
    ti = time.perf_counter()
    pipe = Hunyuan3DPaintPipeline.init_random(0, cfg, device=dev)
    init_s = time.perf_counter() - ti

    # the same stages once more, each with its peak memory and its time on
    # the host's clock (the denoise also by CUDA events); the denoise takes
    # the write stage's reference, so no stage is counted twice
    stages, peaks = {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ts_ = time.perf_counter()
        ev0.record()
        res = fn()
        ev1.record()
        torch.cuda.synchronize()
        stages[name] = {"s": time.perf_counter() - ts_,
                        "cuda_ms": ev0.elapsed_time(ev1)}
        peaks[name] = torch.cuda.max_memory_allocated()
        return res

    img_t = pipe._f32(image)[None]
    normals, positions = stage("render_geometry",
                               lambda: pipe.render_geometry(mesh))
    geom, ilat = stage("encode", lambda: (torch.cat(
        [pipe.encode(normals), pipe.encode(positions)], 1),
        pipe.encode(img_t)))
    ref = stage("write_reference", lambda: pipe.write_reference(ilat))
    latents = stage("denoise", lambda: pipe.denoise(
        geom, ilat, PAINT_STEPS, PAINT_GUIDANCE, PAINT_SEED, ref=ref))
    views = stage("decode", lambda: pipe.decode(latents))
    nv = cfg.num_views
    baked = stage("bake", lambda: pipe.bake(mesh, {
        a: views[i * nv:(i + 1) * nv] for i, a in enumerate(PAINT_PBR)}))
    repeat_diff = float(max(np.abs(baked.albedo - out.albedo).max(),
                            np.abs(baked.metallic_roughness
                                   - out.metallic_roughness).max()))
    steps_tf32_ms = tf32_ms(lambda: pipe.denoise(
        geom, ilat, PAINT_STEPS, PAINT_GUIDANCE, PAINT_SEED, ref=ref), 1,
        warmup=0)

    # one guided step (the uncond and cond passes, the sampler), timed,
    # profiled and its FLOPs counted; the uncond pass's skipped
    # `attn_refview` (the JAX package scales it by 0) counted alone
    sched = make_scheduler(pipe.scheduler_name, cfg.scheduler, PAINT_STEPS)
    cond = pipe.conditioning()
    g2 = torch.Generator().manual_seed(12)
    x0 = (torch.randn(latents.shape, generator=g2).to(dev)
          * sched.init_sigma)
    noise = torch.randn(latents.shape, generator=g2).to(dev)
    geom_rows = geom.repeat(len(PAINT_PBR), 1, 1, 1)

    def one_step():
        eps = pipe.guided_eps(sched.scale_model_input(x0, 0),
                              sched.timesteps[0], geom_rows, ref, cond,
                              PAINT_GUIDANCE)
        return sched.step(eps, 0, x0, noise)

    step_ms = cuda_ms(one_step, 3, warmup=1)
    step_tf32_ms = tf32_ms(one_step, 3)
    prof = profile_frames(one_step, 2, match=SDPA_KERNELS)
    prof["device_idle_share"] = 1.0 - prof["device_union_ms"] \
        / prof["window_ms"]
    step_flops = flops_of(one_step)
    inp = torch.cat([sched.scale_model_input(x0, 0), geom_rows], 1)
    tvec = torch.full((inp.shape[0],), float(sched.timesteps[0]),
                      device=dev)
    cls, ctx_u, _ = cond
    unet = pipe.model.unet
    refview_flops = flops_of(lambda: unet(
        inp, tvec, ctx_u, class_emb=cls, ref_mode="read",
        ref_hidden=ref)) - flops_of(lambda: unet(inp, tvec, ctx_u,
                                                 class_emb=cls))
    write_ms = cuda_ms(lambda: pipe.write_reference(ilat), 3, warmup=1)
    write_flops = flops_of(lambda: pipe.write_reference(ilat))
    decode_flops = flops_of(lambda: pipe.decode(latents))
    rec["b"] = {
        "image": WF_IMAGE, "call_s": call_s,
        "peak_bytes": peak, "spans": spans, "launches": launches,
        "graph": graph, "stages": stages,
        "stage_peak_bytes": peaks,
        "image_to_textures_s": sum(v["s"] for v in stages.values()),
        "repeat_max_abs_diff": repeat_diff,
        "weight_bytes": sum(p.numel() * p.element_size()
                            for p in pipe.model.parameters()),
        "steps_ms": stages["denoise"]["cuda_ms"],
        "steps_ms_tf32": steps_tf32_ms,
        "step_ms": step_ms, "step_ms_tf32": step_tf32_ms,
        "step_flops": step_flops,
        "step_tflops_s": step_flops / step_ms / 1e9,
        "step_tflops_s_tf32": step_flops / step_tf32_ms / 1e9,
        "uncond_refview_flops_skipped": refview_flops,
        "step_profile": {k: v for k, v in prof.items()
                         if k not in ("top", "matched")},
        "step_profile_top": prof["top"][:6],
        "sdpa_kernels": prof["matched"],
        "write_ms": write_ms, "write_flops": write_flops,
        "decode_flops": decode_flops,
        "albedo": tex_stats(out.albedo),
        "metallic_roughness": tex_stats(out.metallic_roughness),
        "glb_bytes": os.path.getsize(glb)}
    log(f"hunyuan3d paint b. the node's defaults: {rec['b']}")
    del latents, views, x0, noise, geom_rows, inp, out, baked, back
    rec["b_s"] = time.perf_counter() - t0

    # c. the bake on a known field: the mesh's own position maps as the six
    # views must give back v·0.5 + 0.5 at the vertices and in the albedo
    t0 = time.perf_counter()
    cams = pipe.cameras()
    colors, conf = CP.project_colors(mesh, positions, cams, cfg.bake_exp,
                                     view_weights=cfg.view_weights,
                                     device=dev)
    info = {}
    baked = CP.bake_projection(mesh, positions, cams,
                               texture_size=cfg.texture_size,
                               cos_power=cfg.bake_exp,
                               view_weights=cfg.view_weights, device=dev,
                               info=info)
    truth = torch.as_tensor(mesh.v) * 0.5 + 0.5
    seen = (conf > 1e-3).cpu()
    corners = seen[torch.as_tensor(mesh.f).long()]        # [M, 3]
    uv = torch.as_tensor(baked.vt)[torch.as_tensor(baked.ft).long()]
    sampled = R.texture_sample(torch.as_tensor(baked.albedo), uv,
                               mode="clamp")             # [M, 3, 3]
    corner_truth = truth[torch.as_tensor(mesh.f).long()]
    rec["c"] = {
        "seen_share": float(seen.float().mean()), "unwrap": info["unwrap"],
        "vertex": err_stats((colors.cpu() - truth)[seen]),
        "vertex_inpainted": err_stats(torch.as_tensor(baked.vc)[seen]
                                      - truth[seen]),
        "albedo_at_uv": err_stats((sampled - corner_truth)[corners])}
    log(f"hunyuan3d paint c. the bake of the position maps: {rec['c']}")
    c = rec["c"]
    check(c["seen_share"] >= BAKE_SEEN_SHARE,
          f"{c['seen_share']:.4f} of the vertices seen")
    for k in ("vertex", "vertex_inpainted", "albedo_at_uv"):
        check(c[k]["mean"] <= TOL_BAKE_MEAN and c[k]["p99"] <= TOL_BAKE_P99,
              f"known-field bake, {k}: {c[k]}")
    rec["c_s"] = time.perf_counter() - t0
    del pipe, normals, positions, geom, ilat, ref
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------------------ #
# The workflows: configs 1–5 and the 3DGS fit as ComfyUI graphs (phase 19)
# ------------------------------------------------------------------ #
C3D = "[Comfy3D] "
WF_VIEWS = 8             # the orbit of 19a and 19f
WF_RADIUS = 2.2          # 19a's orbit radius (phase 4's)
WF_ELEVATION = 15.0
WF_GS_SIZE = 800         # 19a: the GS renderer node's size
WF_MESH_SIZE = 512       # 19a: the mesh renderer node's default
WF_FIT_SIZE = 256        # 19f: the sphere's views and the fit's renders
WF_FIT_ITERS = 100       # 19f: `training_iterations`, through overrides
WF_FIT_BWD_SEED = 13     # 19f: the cotangents of K3′'s hold on view 0
WF_IMAGE = 512           # the LoadImage nodes' reference image
WF_DIR = "workflows"     # under the nodes' output root


def workflow(*nodes):
    """The editor's JSON format from (id, type, widgets_values, {input
    name: (source id, source slot)}) tuples: `nodes` with their
    `inputs` link references, `links` rows [id, from_node, from_slot,
    to_node, to_slot, type]."""
    out, links = [], []
    for nid, type_, widgets, inputs in nodes:
        ins = []
        for slot, (name, (src, src_slot)) in enumerate(inputs.items()):
            links.append([len(links) + 1, src, src_slot, nid, slot, "*"])
            ins.append({"name": name, "link": len(links)})
        out.append({"id": nid, "type": type_, "mode": 0, "inputs": ins,
                    "outputs": [], "widgets_values": list(widgets)})
    return {"nodes": out, "links": links}


def _orbit(nid, radius, views=WF_VIEWS, elevation=WF_ELEVATION):
    """A Stack Orbit Camera Poses node: `views` azimuths from 0 at one
    radius and elevation."""
    return (nid, C3D + "Stack Orbit Camera Poses",
            [radius, radius, 0.1, elevation, elevation, 30.0, 0.0, 360.0,
             360.0 / views], {})


def config_graph(n, image="reference.png", rgba="reference_rgba.png",
                 mesh="uv_cube.glb", splat="splat_100k.ply",
                 sphere="sphere.ply", gs_size=None, fit_size=None,
                 uv_sphere="uv_sphere.glb", fc_mesh="fc_sphere.glb",
                 depth_range=(0.5, 5.5)):
    """The workflow of config `n` (1, 2, 3, 4, "5_shape", "5_texgen",
    "5_full"), of the 3DGS fit ("3dgs_fit"), of CRM ("crm": image → six
    views → six CCMs → mesh; "crm_t2i": the T2I V2 views of the image read
    as normal maps), of Wonder3D ("wonder3d": image → six views and normal
    maps) or of Era3D with the mesh fit ("era3d_fit": image → six views and
    normal maps → masks from the normals → `uv_sphere` fitted to the views)
    or of FlexiCubes ("flexicubes": `fc_mesh`'s 8-view orbit renders at
    `fit_size` → FlexiCubes MVS from their depths, masks and normal maps,
    the depths decoded over `depth_range`) or of TripoSG ("triposg": image
    → mesh; "triposg_scribble": the scribble model's image → mesh) at the
    nodes' defaults, its files named relative to the nodes' input root;
    only the standard library is needed to build it."""
    out = f"{WF_DIR}/" + (n if n in ("3dgs_fit", "crm", "crm_t2i",
                                     "wonder3d", "era3d_fit", "flexicubes",
                                     "triposg", "triposg_scribble")
                          else f"config{n}")
    gs_size = WF_GS_SIZE if gs_size is None else gs_size
    fit_size = WF_FIT_SIZE if fit_size is None else fit_size
    load_rgba = [(1, "LoadImage", [rgba], {}),
                 (2, "InvertMask", [], {"mask": (1, 1)})]
    if n == 1:               # Render_Mesh_and_3DGS
        return workflow(
            (1, C3D + "Load 3D Mesh", [mesh, False, True, False, False], {}),
            _orbit(2, WF_RADIUS),
            (3, C3D + "Mesh Orbit Renderer",
             [WF_MESH_SIZE, 49.1, 1.0, 1.0, 1.0],
             {"mesh": (1, 0), "render_orbit_camera_poses": (2, 0)}),
            (4, "SaveImage", [f"{out}_mesh"], {"images": (3, 0)}),
            (5, C3D + "Load 3DGS", [splat], {}),
            (6, C3D + "Gaussian Splatting Orbit Renderer",
             [gs_size, 49.1, 1.0, 1.0, 1.0],
             {"gs_ply": (5, 0), "render_orbit_camera_poses": (2, 0)}),
            (7, "SaveImage", [f"{out}_gs"], {"images": (6, 0)}))
    if n == 2:               # TripoSR_to_Mesh
        return workflow(
            *load_rgba,
            (3, C3D + "Load TripoSR Model", ["model.ckpt", 8192], {}),
            (4, C3D + "TripoSR", [256, 25.0],
             {"tsr_model": (3, 0), "reference_image": (1, 0),
              "reference_mask": (2, 0)}),
            (5, C3D + "Switch Mesh Axis", ["+x", "+z", "-y", False],
             {"mesh": (4, 0)}),
            (6, C3D + "Save 3D Mesh", [f"{out}_mesh.glb"], {"mesh": (5, 0)}))
    if n == 3:               # Zero123Plus_to_InstantMesh
        return workflow(
            *load_rgba,
            (3, C3D + "Load Diffusers Pipeline",
             ["Zero123PlusPipeline", "sudo-ai/zero123plus-v1.2", "", False],
             {}),
            (4, C3D + "Zero123Plus Diffusion Model",
             [1234, "fixed", 4.0, 28],
             {"zero123plus_pipe": (3, 0), "reference_image": (1, 0),
              "reference_mask": (2, 0)}),
            (5, C3D + "Load InstantMesh Reconstruction Model",
             ["instant_mesh_large.ckpt"], {}),
            (6, C3D + "InstantMesh Reconstruction Model", [30.0, 1024],
             {"lrm_model": (5, 0), "multiview_images": (4, 0),
              "orbit_camera_poses": (4, 1)}),
            (7, C3D + "Save 3D Mesh", [f"{out}_mesh.glb"], {"mesh": (6, 0)}),
            (8, "SaveImage", [f"{out}_views"], {"images": (4, 0)}))
    if n == 4:               # MVDream → LGM → 3DGS and mesh
        return workflow(
            *load_rgba,
            (3, C3D + "Load Diffusers Pipeline",
             ["MVDreamPipeline", "ashawkey/mvdream-sd2.1-diffusers", "",
              False], {}),
            (4, C3D + "MVDream Model",
             ["a robot", "", 0, "fixed", 5.0, 30, 0.0],
             {"mvdream_pipe": (3, 0), "reference_image": (1, 0),
              "reference_mask": (2, 0)}),
            (5, C3D + "Load Large Multiview Gaussian Model",
             ["model_fp16.safetensors"], {}),
            (6, C3D + "Large Multiview Gaussian Model", [],
             {"lgm_model": (5, 0), "multiview_images": (4, 0)}),
            (7, C3D + "Save 3DGS", [f"{out}_gs.ply"], {"gs_ply": (6, 0)}),
            (8, C3D + "Convert 3DGS to Mesh with NeRF and Marching Cubes",
             ["Default", 384, 192, 10.0, 1024], {"gs_ply": (6, 0)}),
            (9, C3D + "Save 3D Mesh", [f"{out}_mesh.glb"], {"mesh": (8, 0)}),
            (10, "SaveImage", [f"{out}_views"], {"images": (4, 0)}))
    shape = [(1, "LoadImage", [image], {}),
             (2, C3D + "Load Hunyuan3D 21 ShapeGen Pipeline", [True], {}),
             (3, C3D + "Hunyuan3D 21 ShapeGen",
              [1234, "fixed", 30, 7.5, 256, True, True],
              {"shapegen_pipe": (2, 0), "image": (1, 0)}),
             (4, C3D + "Save 3D Mesh", [f"{out}_shape.glb"],
              {"mesh": (3, 0)})]
    if n == "5_shape":       # upstream's Hunyuan2.1-Shapegen
        return workflow(*shape)
    if n == "5_texgen":      # upstream's Hunyuan2.1-Texgen
        return workflow(
            (1, "LoadImage", [image], {}),
            (2, C3D + "Load 3D Mesh", [sphere, False, True, False, False],
             {}),
            (3, C3D + "Load Hunyuan3D 21 TexGen Pipeline", ["Turbo"], {}),
            (4, C3D + "Hunyuan3D 21 TexGen", ["", True, True],
             {"texgen_pipe": (3, 0), "image": (1, 0), "mesh": (2, 0)}),
            (5, C3D + "Save 3D Mesh", [f"{out}_textured.glb"],
             {"mesh": (4, 0)}))
    if n == "5_full":        # the two halves linked through the saved file
        return workflow(
            *shape,
            (5, C3D + "Load Hunyuan3D 21 TexGen Pipeline", ["Turbo"], {}),
            (6, C3D + "Hunyuan3D 21 TexGen", ["", True, True],
             {"texgen_pipe": (5, 0), "mesh_path": (4, 0), "image": (3, 1)}),
            (7, C3D + "Save 3D Mesh", [f"{out}_textured.glb"],
             {"mesh": (6, 0)}))
    crm_mv = ["3D assets", "ugly, blurry", 1234, "fixed", 5.5, 50]
    ref = {"reference_image": (1, 0), "reference_mask": (2, 0)}
    if n == "crm":           # upstream's CRM workflow
        return workflow(
            *load_rgba,
            (3, C3D + "Load CRM MVDiffusion Model", ["pixel-diffusion"], {}),
            (4, C3D + "CRM Images MVDiffusion Model", crm_mv,
             {"crm_mvdiffusion_sampler": (3, 0), **ref}),
            (5, C3D + "CRM CCMs MVDiffusion Model", crm_mv,
             {"crm_mvdiffusion_sampler": (3, 1), **ref,
              "multiview_images": (4, 0)}),
            (6, C3D + "Load Convolutional Reconstruction Model", ["CRM.pth"],
             {}),
            (7, C3D + "Convolutional Reconstruction Model", [],
             {"crm_model": (6, 0), "multiview_images": (4, 0),
              "multiview_CCMs": (5, 0)}),
            (8, C3D + "Save 3D Mesh", [f"{out}_mesh.glb"], {"mesh": (7, 0)}),
            (9, "SaveImage", [f"{out}_views"], {"images": (4, 0)}),
            (10, "SaveImage", [f"{out}_ccms"], {"images": (5, 0)}))
    if n == "crm_t2i":       # CRM T2I V2's views
        return workflow(
            *load_rgba,
            (3, C3D + "Load CRM T2I V2 Models",
             ["pixel-diffusion.pth", "sd_v2_base_ipmv_zero_SNR.yaml"], {}),
            (4, C3D + "CRM T2I V2 Models", crm_mv,
             {"t2iadapter_v2": (3, 0), "crm_mvdiffusion_sampler_v2": (3, 1),
              **ref, "normal_maps": (1, 0)}),
            (5, "SaveImage", [f"{out}_views"], {"images": (4, 0)}))
    if n == "wonder3d":      # image → six views and normal maps
        return workflow(
            *load_rgba,
            (3, C3D + "Load Wonder3D Pipeline",
             ["flamehaze1115/wonder3d-v1.0"], {}),
            (4, C3D + "Wonder3D MVDiffusion Model", [0, "fixed", 1.0, 50],
             {"mvdiffusion_pipe": (3, 0), **ref}),
            (5, "SaveImage", [f"{out}_views"], {"images": (4, 0)}),
            (6, "SaveImage", [f"{out}_normals"], {"images": (4, 1)}))
    if n == "era3d_fit":     # image → Era3D's views → a fitted mesh
        return workflow(
            *load_rgba,
            (3, C3D + "Load Era3D Pipeline",
             ["pengHTYX/MacLab-Era3D-512-6view"], {}),
            (4, C3D + "Era3D MVDiffusion Model",
             [420, 600, "fixed", 3.0, 40, 1.0, 4.0],
             {"era3d_pipe": (3, 0), **ref}),
            (5, C3D + "Get Masks From Normal Maps", [],
             {"normal_maps": (4, 1)}),
            (6, C3D + "Load 3D Mesh", [uv_sphere, False, True, False, False],
             {}),
            (7, C3D + "Fitting Mesh With Multiview Images",
             [49.1, 1024, 3, 0.1, True, 512, 512],
             {"mesh": (6, 0), "reference_images": (4, 0),
              "reference_masks": (5, 0),
              "reference_orbit_camera_poses": (4, 2)}),
            (8, C3D + "Save 3D Mesh", [f"{out}_mesh.glb"], {"mesh": (7, 0)}),
            (9, "SaveImage", [f"{out}_views"], {"images": (4, 0)}))
    if n == "3dgs_fit":      # a mesh's orbit renders → 3DGS → its renders
        return workflow(
            (1, C3D + "Load 3D Mesh", [sphere, False, True, False, False],
             {}),
            _orbit(2, MR_RADIUS),
            (3, C3D + "Mesh Orbit Renderer", [fit_size, 49.1, 1.0, 1.0, 1.0],
             {"mesh": (1, 0), "render_orbit_camera_poses": (2, 0)}),
            (4, C3D + "Gaussian Splatting 3D",
             [49.1, 30000, 1, 0.2, 3.0, 0.0, 0.0, 0.5],
             {"reference_images": (3, 0), "reference_masks": (3, 1),
              "reference_orbit_camera_poses": (2, 0)}),
            (5, C3D + "Gaussian Splatting Orbit Renderer",
             [fit_size, 49.1, 1.0, 1.0, 1.0],
             {"gs_ply": (4, 0), "render_orbit_camera_poses": (2, 0)}),
            (6, "SaveImage", [f"{out}_renders"], {"images": (5, 0)}))
    if n == "triposg":       # upstream's TripoSG image → mesh
        return workflow(
            *load_rgba,
            (3, C3D + "Load TripoSG Pipeline", ["VAST-AI/TripoSG"], {}),
            (4, C3D + "TripoSG I23D Model",
             [42, "fixed", 7.0, 50, True, 9, 9, 8],
             {"tsg_pipe": (3, 0), **ref}),
            (5, C3D + "Save 3D Mesh", [f"{out}_mesh.glb"], {"mesh": (4, 0)}))
    if n == "triposg_scribble":   # the scribble model, its image → mesh
        return workflow(
            (1, "LoadImage", [image], {}),
            (2, C3D + "Load Diffusers Pipeline",
             ["TripoSGScribblePipeline", "VAST-AI/TripoSG-scribble", "",
              False], {}),
            (3, C3D + "TripoSG Scribble Model",
             ["3D assets", 42, "fixed", 16, 0.4, 1.0, 8],
             {"tsg_scribble_pipe": (2, 0), "scribble_image": (1, 0)}),
            (4, C3D + "Save 3D Mesh", [f"{out}_mesh.glb"], {"mesh": (3, 0)}))
    if n == "flexicubes":    # a mesh's orbit renders → FlexiCubes → a mesh
        return workflow(
            (1, C3D + "Load 3D Mesh", [fc_mesh, False, True, False, False],
             {}),
            _orbit(2, MR_RADIUS),
            (3, C3D + "Mesh Orbit Renderer", [fit_size, 49.1, 1.0, 1.0, 1.0],
             {"mesh": (1, 0), "render_orbit_camera_poses": (2, 0)}),
            (4, C3D + "FlexiCubes MVS",
             [49.1, 512, 4, 0.01, 128, depth_range[0], depth_range[1], 1.0,
              100.0, 1.0, 0.2, 0.5, 0.1, False],
             {"reference_depth_maps": (3, 2), "reference_masks": (3, 1),
              "reference_orbit_camera_poses": (2, 0),
              "reference_normal_maps": (3, 3)}),
            (5, C3D + "Save 3D Mesh", [f"{out}_mesh.glb"], {"mesh": (4, 0)}))
    raise ValueError(f"no workflow {n!r}")


def write_reference_images(asset_dir, size=WF_IMAGE):
    """`reference_image(size)` as the LoadImage nodes read it: an RGBA PNG
    (its disc the alpha) and an RGB PNG composited on white over the disc.
    Returns the two file names."""
    import cv2
    import numpy as np
    img, mask = reference_image(size)
    rgb = img[0] * mask[0, ..., None] + (1.0 - mask[0, ..., None])
    q = lambda x: np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
    cv2.imwrite(os.path.join(asset_dir, "reference_rgba.png"),
                cv2.cvtColor(np.concatenate([q(img[0]), q(mask[0])[..., None]],
                                            -1), cv2.COLOR_RGBA2BGRA))
    cv2.imwrite(os.path.join(asset_dir, "reference.png"),
                cv2.cvtColor(q(rgb), cv2.COLOR_RGB2BGR))
    return "reference.png", "reference_rgba.png"


def _tensors_of(value):
    """The torch tensors an edge's value holds (a GaussianSplat's fields;
    a host Mesh holds none)."""
    import torch
    if torch.is_tensor(value):
        return [value]
    if hasattr(value, "__dataclass_fields__"):
        return [getattr(value, k) for k in value.__dataclass_fields__
                if torch.is_tensor(getattr(value, k))]
    return []


def run_graph(name, graph, overrides=None, spans=(), device="cuda"):
    """Phase 19's runner: `run_workflow(graph, overrides, device=...)` once
    under the profiler, the compositor kernels' launch counts reset just
    before and read just after. Gates: every node ran, none returned None,
    and every MESH or GS_PLY output's tensors live on `device`. Returns
    (the results, the record: host seconds, each node's host and device ms
    from its `node#<id> <type>` span and the `spans` given, peak memory,
    the launches)."""
    import torch
    from comfy3d_tpu_torch.core.gaussian import GaussianSplat
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.nodes import NODE_CLASS_MAPPINGS, run_workflow
    from comfy3d_tpu_torch.nodes.graph import node_span
    types = {n["id"]: n["type"] for n in graph["nodes"]}
    node_names = {nid: node_span(nid, t) for nid, t in types.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    results, total_s, span_rec, post_s = profile_spans(
        lambda: run_workflow(graph, overrides, device=device),
        list(node_names.values()) + list(spans))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(sorted(results) == sorted(node_names),
          f"{name}: nodes run {sorted(results)}, not {sorted(node_names)}")
    for nid, out in results.items():
        cls = NODE_CLASS_MAPPINGS[types[nid]]
        check(len(out) == len(cls.RETURN_TYPES) and all(
            o is not None for o in out),
            f"{name}: node #{nid} returned {out!r:.200}")
        for o in out:
            if isinstance(o, (Mesh, GaussianSplat)):
                check(all(t.device.type == torch.device(device).type
                          for t in _tensors_of(o)),
                      f"{name}: node #{nid}'s output is off {device}")
    rec = {"s": total_s, "peak_bytes": peak, "launches": launches,
           "nodes": {node_names[nid]: span_rec[node_names[nid]]
                     for nid in node_names},
           "spans": {k: span_rec[k] for k in spans},
           "profiler_post_s": post_s}
    log(f"workflow {name}: {total_s:.1f} s, peak {peak / 2**30:.1f} GiB, "
        f"launches {launches}; nodes " + ", ".join(
            f"{k} {v['host_ms']:.0f} ms" for k, v in rec["nodes"].items()))
    return results, rec


def workflow_files(asset_dir, out_dir):
    """The nodes' input root at `asset_dir` (with no checkpoints under it:
    every loader draws its weights) and their output root at `out_dir`;
    the graphs' input files written there: the reference images
    (`write_reference_images`), phase 13's UV cube as GLB and its sphere,
    with vertex colours, as PLY."""
    from comfy3d_tpu_torch.core.io.ply import save_mesh_ply
    from comfy3d_tpu_torch.nodes import base
    base.INPUT_ROOT_PATH = asset_dir
    base.OUTPUT_ROOT_PATH = out_dir
    base.CKPT_ROOT_PATH = os.path.join(asset_dir, "no_checkpoints")
    write_reference_images(asset_dir)
    uv_cube().write(os.path.join(asset_dir, "uv_cube.glb"))
    sph = sphere_mesh()
    save_mesh_ply(os.path.join(asset_dir, "sphere.ply"), sph.v, sph.f,
                  vc=sph.vc)


def _corner_rows(mesh):
    """Each triangle's corners [F, 9], rows sorted: a mesh's triangles
    whatever their order."""
    import numpy as np
    c = mesh.v[mesh.f].reshape(-1, 9)
    return c[np.lexsort(c.T[::-1])] if len(c) else c


def workflows_path(dev, asset_dir, lgm_splat):
    """Phase 19: configs 1–4 and the 3DGS fit as graphs through
    `run_workflow(..., device="cuda")` at the nodes' defaults (19a–d, 19f)
    on `workflow_files`' inputs; config 5's two graphs (19e) run in phases
    17 and 18. `lgm_splat` is phase 14's LGM output (the same weights and
    seed as 19d's nodes). Returns {graph: record}."""
    import numpy as np
    import torch
    from comfy3d_tpu_torch.algorithms import gs_to_mesh as g2m
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models.triposr import TripoSRPipeline
    from comfy3d_tpu_torch.nodes.nodes_io import read_image
    from comfy3d_tpu_torch.ops import gs_flat
    from comfy3d_tpu_torch.ops import gs_render as G

    recs = {}

    # 19a. config 1: the mesh and the 100k-splat GS-PLY of phase 4, 8 views
    res, rec = run_graph("config1", config_graph(1), device=dev)
    expect_launches(rec["launches"], "flat", WF_VIEWS, 0, "19a")
    poses = res[2][0]
    splat = res[5][0]
    cams = Camera.from_camposes(poses, width=WF_GS_SIZE, height=WF_GS_SIZE,
                                device=dev)
    with torch.no_grad():
        direct = G.render(splat, cams)["image"].cpu()
    rec["gs_vs_render_psnr_db"] = min(
        psnr(res[6][0][i], direct[i]) for i in range(WF_VIEWS))
    check(rec["gs_vs_render_psnr_db"] >= TOL_PSNR_DB,
          f"19a: the renderer node vs render: "
          f"{rec['gs_vs_render_psnr_db']:.2f} dB")
    rec["mesh_alpha_mean"] = float(res[3][1].mean())
    check(0.0 < rec["mesh_alpha_mean"] < 1.0, "19a: the mesh renders")
    recs["config1"] = rec
    del res, splat, direct

    # 19b. config 2: TripoSR at the nodes' defaults but the threshold: a
    # random-weight field's σ lies far under the default 25 (its 98th
    # percentile was 0.37 in phase 11d), so the graph takes the 99.9th
    # percentile of σ at PROBES seeded points of the node's image; the saved
    # mesh against a direct call of the loader's model
    pipe = TripoSRPipeline.init_random(0, device=dev)
    # the node's arithmetic: LoadImage's mask 1 − α, inverted, then the
    # grey composite
    rgb, alpha = read_image(os.path.join(asset_dir, "reference_rgba.png"))
    m = (1.0 - torch.from_numpy(1.0 - alpha))[..., None]
    img = torch.from_numpy(rgb) * m + 0.5 * (1.0 - m)
    r = pipe.cfg.radius
    probes = torch.as_tensor(np.random.RandomState(0).uniform(
        -r, r, (PROBES, 3)).astype(np.float32), device=dev)
    with torch.no_grad():
        codes = pipe.scene_codes(img[None])
        thr = float(np.quantile(pipe.model.query(codes[0], probes)[0]
                                .cpu().numpy(), 0.999))
    graph = config_graph(2)
    tsr_res = graph["nodes"][3]["widgets_values"][0]      # the TripoSR node
    res, rec = run_graph("config2", graph,
                         overrides={4: {"marching_cude_threshold": thr}},
                         device=dev)
    saved = Mesh.load(res[6][0])
    with torch.no_grad():
        ref = pipe.extract_mesh(codes[0], tsr_res, thr).switch_axis(
            "+x+z-y")
    del pipe, codes
    rec.update(threshold=thr, nv=saved.num_vertices, nf=saved.num_faces,
               direct_nf=ref.num_faces)
    check(saved.num_faces > 0, "19b: an empty mesh")
    check(saved.num_faces == ref.num_faces and np.array_equal(
        _corner_rows(saved), _corner_rows(ref)),
          f"19b: the graph's {saved.num_faces} triangles are not the direct "
          f"call's {ref.num_faces}")
    expect_launches(rec["launches"], "flat", 0, 0, "19b")
    recs["config2"] = rec
    del res, saved, ref

    # 19c. config 3: Zero123Plus (28 steps) → InstantMesh
    res, rec = run_graph("config3", config_graph(3), device=dev)
    views, zcfg = res[4][0], res[3][0].cfg
    check(tuple(views.shape) == (6, zcfg.height // 3, zcfg.width // 2, 3)
          and bool(torch.isfinite(views).all()),
          f"19c: views {tuple(views.shape)}")
    mesh = Mesh.load(res[7][0])
    rec.update(nv=mesh.num_vertices, nf=mesh.num_faces)
    expect_launches(rec["launches"], "flat", 0, 0, "19c")
    recs["config3"] = rec
    del res, views, mesh

    # 19d. config 4: MVDream (30 steps) → LGM → 3DGS; the converter at its
    # defaults but G2M_ITERS NeRF iterations (of 384, phase 15's shell's
    # count) → mesh (phase 15c's text → mesh, with its fields)
    cfg = g2m.GSToMeshConfig()
    res, rec = timed_graph("config4", config_graph(4), overrides={
        8: {"training_nerf_iterations": G2M_ITERS}}, device=dev)
    expect_launches(rec["launches"], "flat", cfg.n_views, 0, "19d")
    mesh = res[8][0]
    check(bool(np.isfinite(mesh.v).all()), "19d: non-finite vertices")
    check(mesh.albedo is None or (bool(np.isfinite(mesh.albedo).all())
                                  and mesh.albedo.min() >= 0
                                  and mesh.albedo.max() <= 1),
          "19d: albedo outside [0, 1]")
    splats = res[6][0]
    check(all(t.device.type == dev.type for t in _tensors_of(splats)),
          "19d: the splats are off the card")
    nodes = rec["nodes"]
    rec.update(
        nv=mesh.num_vertices, nf=mesh.num_faces,
        text_to_mesh_s=rec["s"], ngp_iters=G2M_ITERS,
        # the MVDream and LGM nodes (#4, #6), their loaders left out
        text_to_splats_s=sum(v for k, v in nodes.items()
                             if k.startswith(("node#4 ", "node#6 "))),
        splats_vs_phase_14_max_abs=float(
            (splats.xyz - lgm_splat.xyz).abs().max()))
    recs["config4"] = rec
    del res, mesh, splats

    # 19f. the 3DGS fit: the sphere's 8 views at 256² → WF_FIT_ITERS
    # iterations at batch 1 → the fit's 8 renders
    res, rec = timed_graph("3dgs_fit", config_graph("3dgs_fit"),
                           overrides={4: {"training_iterations":
                                          WF_FIT_ITERS}}, device=dev)
    expect_launches(rec["launches"], "flat", WF_FIT_ITERS + WF_VIEWS,
                    WF_FIT_ITERS, "19f")
    fitted = res[4][0]
    renders = res[5][0]
    check(all(t.device.type == dev.type for t in _tensors_of(fitted)),
          "19f: the fitted splats are off the card")
    check(all(bool(torch.isfinite(t).all()) for t in
              (fitted.xyz, fitted.sh, fitted.opacity_raw, fitted.scale_raw,
               fitted.rot_raw, renders)), "19f: non-finite result")
    rec.update(iterations=WF_FIT_ITERS, size=WF_FIT_SIZE,
               alive=int(fitted.alive.sum()),
               render_vs_reference_psnr_db=psnr(renders, res[3][0]))
    # K1′ and K3′ on the fitted splat from view 0 of the fit's own cameras,
    # against their plain versions at phases 3 and 5's tolerances
    cams = Camera.from_camposes(res[2][0], fovy_deg=49.1, width=WF_FIT_SIZE,
                                height=WF_FIT_SIZE, device=dev)
    cam0 = Camera(c2w=cams.c2w[0], fovy_deg=cams.fovy_deg[0],
                  width=WF_FIT_SIZE, height=WF_FIT_SIZE, near=cams.near,
                  far=cams.far)
    inp = flat_inputs(fitted, cam0)
    cmp, fwd, _ = kernel_vs_plain("3dgs_fit_view0", inp, True)
    box = flat_box_stats(inp, fwd[2])
    check_box(box, "3dgs_fit view 0")
    kargs, _ = flat_kernel_args(inp, True)
    bargs, _ = bwd_args(inp, fwd, WF_FIT_BWD_SEED)
    rec["view0"] = dict(
        cmp, box=box, bound=flat_fwd_bound(inp, fwd[2], box),
        kernel_ms=cuda_ms(lambda: gs_flat.composite_bins_fwd_rows(*kargs),
                          20),
        plain_ms=cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows_plain(*kargs), 5,
            warmup=1), **coarse_overflow(inp))
    rec["view0_bwd"] = dict(
        bwd_vs_plain("3dgs_fit_view0", inp, fwd, WF_FIT_BWD_SEED),
        bound=bwd_bound(inp, fwd[2]),
        kernel_ms=cuda_ms(
            lambda: gs_flat.composite_bins_bwd_splats(*bargs), 20),
        plain_ms=cuda_ms(
            lambda: gs_flat.composite_bins_bwd_splats_plain(*bargs), 3,
            warmup=1))
    log(f"19f view 0: K1′ {rec['view0']}, K3′ {rec['view0_bwd']}")
    recs["3dgs_fit"] = rec
    del res, fitted, renders, inp, fwd, kargs, bargs
    torch.cuda.empty_cache()
    return recs


# ------------------------------------------------------------------ #
# CRM image → six views → six CCMs → mesh; ImageDream → LGM (phase 20)
# ------------------------------------------------------------------ #
TOL_CRM_REL = 1e-3       # card vs CPU, of the largest value, TF32 off
CRM_STEPS = 50           # the CRM samplers' nodes' defaults
CRM_TIMED_STEPS = 25     # 20b-c: the samplers timed at full width
CRM_GUIDANCE = 5.5
CRM_SEED = 1234
CRM_T2I_STEPS = 10       # 20e's T2I V2 graph (the node's 50, cut)
# 20e's CRM graph: each sampler's 50 steps cut to 20 (20b-c run the 50),
# which also shortens the profile read after it
CRM_GRAPH_STEPS = 20
CRM_VIEW = 256           # the reference image the samplers take
CRM_SPHERE_TOL = 0.01    # 20d: the analytic sphere's area, of π
ID_STEPS = 30            # 20f: the MVDream_Model node's defaults
ID_GUIDANCE = 5.0
# 20a's cut (the widths kept): one resnet per block in the UNets and the
# VAE, 2 ViT-H layers, 2 views (+ the pinned frame), a 64×192 strip
CRM_SMALL = dict(layers_per_block=1, clip_layers=2, views=2, plane=64)


def crm_mv_config(in_channels, num_views=6, **overrides):
    """The SD-2.1 ImageDream config `load_ldm_checkpoint` builds (16 IP
    tokens): CRM's pixel stage (4 input channels) and CCM stage (8), and at
    4 views the imagedream-ipmv widths."""
    from comfy3d_tpu_torch.models.mvdream.convert import ldm_config
    return ldm_config(in_channels, num_views=num_views, **overrides)


def crm_vision_config(**overrides):
    """ImageDream's OpenCLIP ViT-H/14 visual tower."""
    import dataclasses
    from comfy3d_tpu_torch.models.mvdream.convert import ldm_vision_config
    return dataclasses.replace(ldm_vision_config(), **overrides)


def crm_recon_config(**overrides):
    import dataclasses
    from comfy3d_tpu_torch.models.crm import CRMConfig
    return dataclasses.replace(CRMConfig(), **overrides)


def vision_encoder_on(seed, cfg, device):
    """A CLIP vision encoder with weights from `seed` drawn on `device`: the
    JAX package's scheme for its linear, conv and norm layers, the class
    token and positions normal with std 0.02."""
    import torch
    from comfy3d_tpu_torch.models import clip
    from comfy3d_tpu_torch.models.common import init_weights_, seeded_model

    def init(model, gen):
        init_weights_(model, gen)
        emb = model.embeddings
        with torch.no_grad():
            for p in (emb.class_embedding, emb.position_embedding.weight):
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=gen.device) * 0.02)
    return seeded_model(lambda: clip.CLIPVisionEncoder(cfg), init, seed,
                        device).eval()


def crm_reference(size=CRM_VIEW):
    """`reference_image(size)` composited on white over its disc, as the
    CRM nodes take it: [S, S, 3]."""
    import numpy as np
    img, mask = reference_image(size)
    return (img[0] * mask[0, ..., None]
            + (1.0 - mask[0, ..., None])).astype(np.float32)


def sampler_stage(name, pipe, steps, guidance, sample_kw, gen_seed,
                  node_steps):
    """One multi-view sampler at full width: the sampling of `steps` steps
    (`timed_steps`; the node's default is `node_steps`) by CUDA events in
    f32 and in TF32, one guided step timed (f32, TF32), its FLOPs
    counted from the shapes (`torch.utils.flop_counter`), profiled (the
    idle share of the profiled window, the SDPA kernels) and the peak
    memory of the sampling. Returns (record, the f32 views)."""
    import torch
    from comfy3d_tpu_torch.models.diffusion.schedulers import (
        SchedulerConfig, make_scheduler)

    def sample():
        return pipe(num_inference_steps=steps, guidance_scale=guidance,
                    generator=torch.Generator().manual_seed(gen_seed),
                    **sample_kw)

    pipe(num_inference_steps=2, guidance_scale=guidance, **sample_kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    views = sample()
    end.record()
    torch.cuda.synchronize()
    views_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    views_tf32_ms = tf32_ms(sample, 1, warmup=0)
    cond = pipe.conditioning(**{k: v for k, v in sample_kw.items()
                                if k in ("image", "pixel_images")})
    sched = make_scheduler(pipe.scheduler_name, SchedulerConfig(), steps)
    x0 = pipe.initial_latents(torch.Generator().manual_seed(gen_seed),
                              cond.frames)
    t0 = int(sched.timesteps[0])

    def one_step():
        return sched.step(pipe.guided_eps(x0, t0, cond, guidance), 0, x0)

    step_ms = cuda_ms(one_step, 3, warmup=1)
    step_tf32_ms = tf32_ms(one_step, 3)
    flops = flops_of(one_step)
    prof = profile_frames(one_step, 2, match=SDPA_KERNELS)
    prof["device_idle_share"] = 1.0 - prof["device_union_ms"] \
        / prof["window_ms"]
    rec = {"steps": steps, "guidance_scale": guidance,
           "frames": cond.frames, "cfg_batch": 2 * cond.frames,
           "timed_steps": steps, "node_steps": node_steps,
           "ms": views_ms, "ms_tf32": views_tf32_ms, "peak_bytes": peak,
           "step_ms": step_ms, "step_ms_tf32": step_tf32_ms,
           "step_tflop": flops / 1e12,
           "step_tflops_s": flops / step_ms / 1e9,
           "step_tflops_s_tf32": flops / step_tf32_ms / 1e9,
           "step_profile": {k: v for k, v in prof.items() if k != "top"},
           "step_profile_top": prof["top"][:6],
           "params": count_params(pipe.model.unet),
           "mean": float(views.mean()),
           "clipped_share": float(((views == 0) | (views == 1)).float()
                                  .mean())}
    check(tuple(views.shape) == (pipe.cfg.num_views, pipe.cfg.image_size,
                                 pipe.cfg.image_size, 3),
          f"{name}: views {tuple(views.shape)}")
    check(bool(torch.isfinite(views).all()) and float(views.min()) >= 0.0
          and float(views.max()) <= 1.0, f"{name}: views not in [0, 1]")
    log(f"crm {name}: {rec}")
    return rec, views


def crm_path(dev, asset_dir, smi_line):
    """Phase 20: CRM's image → six views → six CCMs → mesh at the
    samplers' SD-2.1 ipmv widths (`load_ldm_checkpoint`'s config, a ViT-H/14
    penultimate conditioner) and `CRMConfig()`, the CRM graphs at the
    nodes' defaults, and ImageDream → LGM → the converter's orbit. Weights
    from seeds, drawn on the card. Runs under `torch.no_grad()`."""
    import copy as copy_
    import dataclasses
    import warnings

    import numpy as np
    import torch
    from comfy3d_tpu_torch.algorithms.gs_to_mesh import (GSToMeshConfig,
                                                         orbit_cameras)
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models import clip
    from comfy3d_tpu_torch.models.crm import CRMReconPipeline
    from comfy3d_tpu_torch.models.diffusion.schedulers import (
        DDIM, SchedulerConfig)
    from comfy3d_tpu_torch.models.lgm import LGMConfig, LGMPipeline
    from comfy3d_tpu_torch.models.diffusion.config import load_module
    from comfy3d_tpu_torch.models.mvdream import MVDream, MVDreamPipeline
    from comfy3d_tpu_torch.ops import gs_flat, tetra
    from comfy3d_tpu_torch.ops import gs_render as G

    cpu = torch.device("cpu")
    rec = {"card": smi_line, "seed": CRM_SEED}
    ref_img = crm_reference()
    rng = np.random.RandomState(20)

    # a. the card against the port's CPU path at reduced depth, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    sm = CRM_SMALL
    v = sm["views"]

    def small_mv(cin):
        c = crm_mv_config(cin, num_views=v)
        return dataclasses.replace(
            c, unet=dataclasses.replace(
                c.unet, layers_per_block=sm["layers_per_block"]),
            vae=dataclasses.replace(
                c.vae, layers_per_block=sm["layers_per_block"]))

    host_enc = vision_encoder_on(1, crm_vision_config(
        layers=sm["clip_layers"]), cpu)
    host_pix = MVDreamPipeline.init_random(0, small_mv(4), device=cpu)
    # the CCM stage shares the pixel stage's host draw, its conv_in's 4
    # more input channels a copy of the first 4 (the std kept)
    sd = dict(host_pix.model.state_dict())
    w = sd["unet.conv_in.weight"]
    sd["unet.conv_in.weight"] = torch.cat([w, w], 1) * 0.5 ** 0.5
    host_ccm = MVDreamPipeline(load_module(lambda: MVDream(small_mv(8)), sd,
                                           cpu))
    del sd, w
    host_crm = CRMReconPipeline.init_random(0, crm_recon_config(
        plane_resolution=sm["plane"], unet=dataclasses.replace(
            crm_recon_config().unet,
            layers_per_block=sm["layers_per_block"])), device=cpu)
    pix_np = rng.rand(v, 256, 256, 3).astype(np.float32)
    lat = host_pix.cfg.image_size // host_pix.cfg.vae_factor
    x_np = rng.randn(v + 1, 4, lat, lat).astype(np.float32)
    strip_np = rng.rand(sm["plane"], 3 * sm["plane"], 12).astype(np.float32)
    probes_np = (rng.rand(PROBES, 3) * 2 - 1).astype(np.float32)
    cs = host_enc.cfg.image_size
    clip_np = rng.rand(1, 3, cs, cs).astype(np.float32)
    t_first = int(DDIM(SchedulerConfig(), CRM_STEPS).timesteps[0])
    outs = {}
    for d in (cpu, dev):
        th = time.perf_counter()
        enc = copy_.deepcopy(host_enc).to(d)
        pix, ccm, crm = (pipe_on(p, d) for p in (host_pix, host_ccm,
                                                 host_crm))
        for p in (pix, ccm):
            p.set_vision_encoder(clip.make_vision_hidden_conditioner(enc))
        x = torch.as_tensor(x_np, device=d)
        c_pix = pix.conditioning(image=ref_img)
        c_ccm = ccm.conditioning(image=ref_img, pixel_images=pix_np)
        planes = crm.planes(strip_np)
        sdf, deform, rgb = crm.model.query(planes, torch.as_tensor(
            probes_np, device=d))
        o = {"clip_penultimate": enc(torch.as_tensor(clip_np, device=d),
                                     project="penultimate")[0],
             "ip_tokens": c_pix.states[-1, -pix.cfg.ip_dim:],
             "pinned_latent": c_pix.pinned[1],
             "pixel_eps": pix.guided_eps(x, t_first, c_pix, CRM_GUIDANCE),
             "pixel_latents": c_ccm.pixels[v:],
             "ccm_eps": ccm.guided_eps(x[:v], t_first, c_ccm, CRM_GUIDANCE),
             "planes": planes, "sdf": sdf, "deform": deform, "rgb": rgb}
        if d.type == "cuda":
            torch.cuda.synchronize()
        outs[d.type] = o
        outs[d.type + "_s"] = time.perf_counter() - th
        del enc, pix, ccm, crm
    parity = {"cut": sm, "t": t_first, "host_s": outs["cpu_s"],
              "card_s": outs[dev.type + "_s"]}
    for k, ref in outs["cpu"].items():
        parity[f"{k}_rel_err"] = rel_err(outs[dev.type][k], ref)
    log(f"crm a. card vs CPU (TF32 off): {parity}")
    for k in outs["cpu"]:
        check(parity[f"{k}_rel_err"] <= TOL_CRM_REL,
              f"crm {k}: card vs CPU {parity[k + '_rel_err']:.3g} of the "
              f"largest value")
    rec["card_vs_cpu"] = parity
    del outs, host_enc, host_pix, host_ccm, host_crm
    rec["a_s"] = time.perf_counter() - t0

    # b. the pixel stage at full width: 6 views + the pinned frame
    t0 = time.perf_counter()
    reset_launches()
    enc = vision_encoder_on(1, crm_vision_config(), dev)
    pix = MVDreamPipeline.init_random(0, crm_mv_config(4), device=dev)
    pix.set_vision_encoder(clip.make_vision_hidden_conditioner(enc))
    init_s = time.perf_counter() - t0
    clip_ms = cuda_ms(lambda: pix.vision_encoder(ref_img), 5)
    rec["pixel"], views = sampler_stage(
        "b. pixel stage", pix, CRM_TIMED_STEPS, CRM_GUIDANCE,
        {"image": ref_img}, CRM_SEED, node_steps=CRM_STEPS)
    rec["pixel"].update(init_s=init_s, clip_ms=clip_ms,
                        clip_params=count_params(enc),
                        resampler_params=count_params(pix.model.image_embed))
    del pix
    torch.cuda.empty_cache()
    rec["b_s"] = time.perf_counter() - t0

    # c. the CCM stage at full width: the pixel views' latents, 6 frames
    t0 = time.perf_counter()
    ccm = MVDreamPipeline.init_random(1, crm_mv_config(8), device=dev)
    ccm.set_vision_encoder(clip.make_vision_hidden_conditioner(enc))
    rec["ccm"], ccms = sampler_stage(
        "c. CCM stage", ccm, CRM_TIMED_STEPS, CRM_GUIDANCE,
        {"image": ref_img, "pixel_images": views}, CRM_SEED + 1,
        node_steps=CRM_STEPS)
    del ccm
    torch.cuda.empty_cache()
    rec["c_s"] = time.perf_counter() - t0

    # d. the reconstructor at CRMConfig(): forward, 81³ query, extraction,
    # colours, each timed; an analytic sphere
    t0 = time.perf_counter()
    crm = CRMReconPipeline.init_random(0, crm_recon_config(), device=dev)
    rcfg = crm.cfg
    strip = crm.make_strip(views, ccms)
    fwd_ms = cuda_ms(lambda: crm.planes(strip), 3, warmup=1)
    fwd_tf32_ms = tf32_ms(lambda: crm.planes(strip), 3)
    fwd_flops = flops_of(lambda: crm.planes(strip))
    planes = crm.planes(strip)
    query_ms = cuda_ms(lambda: crm.sdf_grid(planes), 3, warmup=1)
    grid = crm.sdf_grid(planes)
    res = rcfg.tet_grid_size + 1
    check(tuple(grid.shape) == (res,) * 3 and bool(torch.isfinite(
        grid).all()), f"SDF grid {tuple(grid.shape)}")
    te = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = tetra.extract_isosurface(grid, iso=0.0, bounds=(-1.0, 1.0))
    extract_s = time.perf_counter() - te
    tc = time.perf_counter()
    if mesh.num_vertices:
        mesh.vc = crm.vertex_colors(planes, mesh.v)
    colors_s = time.perf_counter() - tc
    torch.cuda.synchronize()
    te = time.perf_counter()
    mesh2 = crm(views, ccms)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - te
    check(mesh.num_faces > 0 and int(mesh.f.max()) < mesh.num_vertices,
          "empty or ill-formed CRM mesh")
    check(mesh.vc is not None and np.isfinite(mesh.vc).all()
          and mesh.vc.min() >= 0 and mesh.vc.max() <= 1, "vertex colours")
    glb = os.path.join(asset_dir, "crm_mesh.glb")
    mesh2.write(glb)
    back = Mesh.load(glb)
    check(np.array_equal(back.v, mesh2.v) and np.array_equal(
        back.f, mesh2.f), "GLB round trip changed the mesh")
    # the analytic gate: sdfMlp.fc3 zeroed, the SDF is 0.5 − ‖x‖
    sph = copy_.deepcopy(crm.model)
    sph.sdfMlp.fc3.weight.zero_()
    sph.sdfMlp.fc3.bias.zero_()
    sgrid = CRMReconPipeline(sph).sdf_grid(planes)
    with warnings.catch_warnings(record=True) as s_caught:
        warnings.simplefilter("always")
        smesh = tetra.extract_isosurface(sgrid, iso=0.0, bounds=(-1.0, 1.0))
    area = mesh_area(torch.as_tensor(smesh.v), torch.as_tensor(smesh.f))
    sphere = {"nv": smesh.num_vertices, "nf": smesh.num_faces,
              "area": area, "area_rel_err": abs(area - math.pi) / math.pi,
              "overflow_warnings": [str(w.message) for w in s_caught],
              "radius_max_err": float(np.abs(np.linalg.norm(
                  smesh.v, axis=1) - 0.5).max())}
    check(sphere["area_rel_err"] <= CRM_SPHERE_TOL and not s_caught,
          f"CRM analytic sphere: {sphere}")
    del sph
    rec["recon"] = {
        "config": dataclasses.asdict(rcfg),
        "params": count_params(crm.model),
        "forward_ms": fwd_ms, "forward_ms_tf32": fwd_tf32_ms,
        "forward_tflop": fwd_flops / 1e12,
        "forward_tflops_s": fwd_flops / fwd_ms / 1e9,
        "query_ms": query_ms, "query_points": res ** 3,
        "extract_s": extract_s, "colors_s": colors_s, "call_s": call_s,
        "nv": mesh.num_vertices, "nf": mesh.num_faces,
        "call_nf": mesh2.num_faces,
        "call_equals_stages": bool(mesh2.num_faces == mesh.num_faces
                                   and np.array_equal(mesh2.f, mesh.f)),
        "overflow_warnings": [str(w.message) for w in caught],
        "glb_bytes": os.path.getsize(glb), "analytic_sphere": sphere}
    log(f"crm d. reconstructor: {rec['recon']}")
    rec["launches"] = read_launches()
    check(not any(rec["launches"].values()),
          f"the CRM path launched a compositor kernel: {rec['launches']}")
    del crm, planes, grid, sgrid
    torch.cuda.empty_cache()
    rec["d_s"] = time.perf_counter() - t0

    # e. the CRM graphs at the nodes' defaults, loaders drawing on the card
    t0 = time.perf_counter()
    graphs = {}
    results, graphs["crm"] = timed_graph(
        "crm", config_graph("crm"),
        {n: {"num_inference_steps": CRM_GRAPH_STEPS} for n in (4, 5)},
        device=dev)
    g_mesh = results[7][0]
    check(g_mesh.num_faces > 0 and tuple(results[4][0].shape)
          == tuple(results[5][0].shape) == (6, CRM_VIEW, CRM_VIEW, 3),
          "the CRM graph's views, CCMs or mesh")
    graphs["crm"].update(nv=g_mesh.num_vertices, nf=g_mesh.num_faces,
                         steps=CRM_GRAPH_STEPS)
    results, graphs["crm_t2i"] = run_graph(
        "crm_t2i", config_graph("crm_t2i"),
        {4: {"num_inference_steps": CRM_T2I_STEPS}}, device=dev)
    check(tuple(results[4][0].shape) == (6, CRM_VIEW, CRM_VIEW, 3),
          "the T2I graph's views")
    graphs["crm_t2i"]["steps"] = CRM_T2I_STEPS
    for name, g in graphs.items():
        check(not any(g["launches"].values()),
              f"graph {name} launched a compositor kernel: {g['launches']}")
    rec["graphs"] = graphs
    del results, g_mesh
    torch.cuda.empty_cache()
    rec["e_s"] = time.perf_counter() - t0

    # f. ImageDream (4 views + the pinned frame) → LGM → the orbit via K1′
    t0 = time.perf_counter()
    idp = MVDreamPipeline.init_random(2, crm_mv_config(4, num_views=4),
                                      device=dev)
    idp.set_vision_encoder(clip.make_vision_hidden_conditioner(enc))
    lgm = LGMPipeline.init_random(0, LGMConfig(), device=dev)
    torch.cuda.synchronize()
    ti = time.perf_counter()
    id_views = idp(image=ref_img, num_inference_steps=ID_STEPS,
                   guidance_scale=ID_GUIDANCE,
                   generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    views_s = time.perf_counter() - ti
    check(tuple(id_views.shape) == (4, CRM_VIEW, CRM_VIEW, 3) and bool(
        torch.isfinite(id_views).all()), "ImageDream views")
    splat = lgm.forward_gaussians(id_views)
    g2m_cfg = GSToMeshConfig()
    cams = orbit_cameras(g2m_cfg, device=dev)
    kw = dict(background=(1.0, 1.0, 1.0), backend="flat")
    torch.cuda.synchronize()
    reset_launches()
    out = G.render(splat, cams, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches, "flat", GS_ORBIT_VIEWS, 0,
                    "ImageDream → LGM orbit")
    img = out["image"]
    check(bool(torch.isfinite(img).all()), "non-finite orbit")
    orbit_ms = cuda_ms(lambda: G.render(splat, cams, **kw), 3, warmup=1)
    cam0 = Camera(c2w=cams.c2w[0], fovy_deg=cams.fovy_deg[0],
                  width=GS_ORBIT_SIZE, height=GS_ORBIT_SIZE, near=cams.near,
                  far=cams.far)
    inp = flat_inputs(splat, cam0)
    cmp, (_, _, stops), plain_img = kernel_vs_plain("imagedream_lgm_view0",
                                                    inp, True)
    view0_db = psnr(img[0], plain_img)
    check(view0_db >= TOL_PSNR_DB,
          f"ImageDream orbit view 0 vs the plain compositor: {view0_db:.2f}")
    box = flat_box_stats(inp, stops)
    check_box(box, "ImageDream orbit view 0")
    bound = flat_fwd_bound(inp, stops, box)
    kargs, _ = flat_kernel_args(inp, True)
    k_ms = cuda_ms(lambda: gs_flat.composite_bins_fwd_rows(*kargs), 20)
    p_ms = cuda_ms(lambda: gs_flat.composite_bins_fwd_rows_plain(*kargs), 5,
                   warmup=1)
    rec["imagedream_lgm"] = {
        "steps": ID_STEPS, "guidance_scale": ID_GUIDANCE, "frames": 5,
        "image_to_views_s": views_s, "splats": splat.num_capacity,
        "orbit": {"views": GS_ORBIT_VIEWS, "size": GS_ORBIT_SIZE,
                  "launches": launches, "ms": orbit_ms,
                  "view0": dict(cmp, view_vs_plain_psnr_db=view0_db,
                                kernel_ms=k_ms, plain_ms=p_ms, box=box,
                                bound=bound)}}
    log(f"crm f. ImageDream → LGM: {rec['imagedream_lgm']}")
    del idp, lgm, enc, splat, inp, out, img
    torch.cuda.empty_cache()
    rec["f_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------------ #
# Wonder3D and Era3D image → six views + normal maps → the mesh fit
# (phase 21)
# ------------------------------------------------------------------ #
TOL_MV_REL = 1e-3        # card vs CPU, of the largest value, TF32 off
ERA3D_STEPS = 40         # the Era3D node's defaults
ERA3D_TIMED_STEPS = 10   # 21b: the sampler timed at full width
ERA3D_GUIDANCE = 3.0
ERA3D_SEED = 600
ERA3D_RADIUS = 4.0
ERA3D_AZIMUTHS = (0.0, 45.0, 90.0, 180.0, 270.0, 315.0)
W3D_STEPS = 50           # the Wonder3D node's defaults
W3D_GUIDANCE = 1.0
W3D_SEED = 0
# 21d: the graph's Era3D steps (the node's 40, run in full in 21b) and the
# fit node's 1,024 iterations, cut to one remesh (at the widget's least,
# 128) and a few steps after it
FIT_GRAPH_STEPS = 10
FIT_ITERS = 136
FIT_REMESH = 128
FIT_PROFILE_STEPS = 1
# 21e: the analytic fit — a textured UV sphere scaled by GATE_SCALE with a
# flat grey texture fitted back to the sphere's six Era3D views at
# GATE_SIZE² for GATE_ITERS steps (the vertex rate of the JAX package's
# own shrink test)
GATE_SIZE = 256
GATE_ITERS = 120
GATE_SCALE = 1.15
GATE_LR_VERTS = 5e-3
GATE_TEXTURE = 64
GATE_PSNR_GAIN_DB = 1.0  # the masked render's PSNR must rise by this
GATE_VERT_SHRINK = 0.95  # the mean vertex error must fall below this share
# 21a's cut (the widths kept): one resnet per block in the UNets and the
# VAE, 2 CLIP layers, 64² views, the fit at 128² on a 24 × 48 UV sphere
MV_SMALL = dict(layers_per_block=1, clip_layers=2, image=64, fit_size=128)


def era3d_vision_config(**overrides):
    """Era3D's unCLIP image encoder: a ViT-H/14 with projection 1024."""
    import dataclasses
    return dataclasses.replace(crm_vision_config(), **overrides)


def w3d_vision_config(**overrides):
    """Wonder3D's image encoder: CLIP ViT-L/14 with projection 768."""
    import dataclasses
    from comfy3d_tpu_torch.models.clip import CLIPVisionConfig
    return dataclasses.replace(CLIPVisionConfig(), **overrides)


def era3d_poses(radius=ERA3D_RADIUS):
    """The Era3D node's ORBIT_CAMPOSES rows."""
    return [[radius, 0.0, a, 0.0, 0.0, 0.0] for a in ERA3D_AZIMUTHS]


def gate_texture(size=GATE_TEXTURE):
    """A smooth seeded-free RGB pattern in (0.1, 0.9)."""
    import numpy as np
    u = np.linspace(0.0, 1.0, size, dtype=np.float32)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    return np.stack([0.5 + 0.4 * np.sin(2 * np.pi * uu),
                     0.5 + 0.4 * np.cos(2 * np.pi * vv),
                     0.5 + 0.3 * np.sin(4 * np.pi * (uu + vv))],
                    -1).astype(np.float32)


def _mv_stage(name, pipe, image, steps, guidance, seed, one_step,
              tf32_sampler, node_steps):
    """One multi-view family at full width: the whole sampler of `steps`
    steps (`timed_steps`; the node's default is `node_steps`; the VAE
    encode, CLIP and decode included) by CUDA events in f32 (and TF32 with
    `tf32_sampler`), one guided step timed f32 and TF32, its FLOPs counted
    (`torch.utils.flop_counter`), profiled (idle share, SDPA kernels), the
    decode of 2V views alone, and the peak memory of the sampler, the step
    and the decode. Returns (record, colours, normals)."""
    import torch
    cfg = pipe.cfg

    def sample():
        return pipe(image, num_inference_steps=steps,
                    guidance_scale=guidance, seed=seed)

    pipe(image, num_inference_steps=2, guidance_scale=guidance, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    colors, normals = sample()
    end.record()
    torch.cuda.synchronize()
    sampler_ms = start.elapsed_time(end)
    peak_sampler = torch.cuda.max_memory_allocated()
    sampler_tf32_ms = tf32_ms(sample, 1, warmup=0) if tf32_sampler else None
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(one_step, 3, warmup=1)
    peak_step = torch.cuda.max_memory_allocated()
    step_tf32_ms = tf32_ms(one_step, 3)
    flops = flops_of(one_step)
    prof = profile_frames(one_step, 2, match=SDPA_KERNELS)
    prof["device_idle_share"] = 1.0 - prof["device_union_ms"] \
        / prof["window_ms"]
    lat = torch.randn((2 * cfg.num_views, cfg.vae.latent_channels,
                       cfg.image_size // 8, cfg.image_size // 8),
                      generator=torch.Generator().manual_seed(1)).to(
        pipe.device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        decode_ms = cuda_ms(lambda: pipe.model.vae.decode(lat), 2, warmup=1)
    peak_decode = torch.cuda.max_memory_allocated()
    rec = {"steps": steps, "guidance_scale": guidance, "seed": seed,
           "image_size": cfg.image_size, "views": cfg.num_views,
           "timed_steps": steps, "node_steps": node_steps,
           "sampler_ms": sampler_ms, "sampler_ms_tf32": sampler_tf32_ms,
           "step_ms": step_ms, "step_ms_tf32": step_tf32_ms,
           "step_tflop": flops / 1e12,
           "step_tflops_s": flops / step_ms / 1e9,
           "step_tflops_s_tf32": flops / step_tf32_ms / 1e9,
           "step_profile": {k: v for k, v in prof.items() if k != "top"},
           "step_profile_top": prof["top"][:6],
           "decode_views": 2 * cfg.num_views, "decode_ms": decode_ms,
           "peak_bytes": {"sampler": peak_sampler, "step": peak_step,
                          "decode": peak_decode},
           "unet_params": count_params(pipe.model.unet),
           "mean": float(colors.mean()),
           "normals_mean": float(normals.mean())}
    for what, x in (("colours", colors), ("normals", normals)):
        check(tuple(x.shape) == (cfg.num_views, cfg.image_size,
                                 cfg.image_size, 3), f"{name}: {what} "
              f"{tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()) and float(x.min()) >= 0.0
              and float(x.max()) <= 1.0, f"{name}: {what} not in [0, 1]")
    log(f"mvdiffusion {name}: {rec}")
    return rec, colors, normals


def timed_graph(name, graph, overrides=None, device="cuda"):
    """`run_workflow(graph, overrides, device=...)` with each node's call
    timed on the host's clock between two synchronisations (no profiler:
    a fit of thousands of raster launches per step makes a profile of the
    graph minutes long), the compositor kernels' launches reset just before
    and read just after, peak memory. Gates as `run_graph`'s. Returns (the
    results, the record)."""
    import torch
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.nodes import NODE_CLASS_MAPPINGS, run_workflow
    from comfy3d_tpu_torch.nodes.graph import node_span
    types = {n["id"]: n["type"] for n in graph["nodes"]}
    seconds, saved = {}, {}
    for t in set(types.values()):
        cls = NODE_CLASS_MAPPINGS[t]
        fn = getattr(cls, cls.FUNCTION)
        saved[cls] = fn

        def timed(self, *a, _fn=fn, _t=t, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(self, *a, **kw)
            torch.cuda.synchronize()
            seconds.setdefault(_t, []).append(time.perf_counter() - t0)
            return out
        setattr(cls, cls.FUNCTION, timed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        t0 = time.perf_counter()
        results = run_workflow(graph, overrides, device=device)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    finally:
        for cls, fn in saved.items():
            setattr(cls, cls.FUNCTION, fn)
    launches = read_launches()
    check(sorted(results) == sorted(types),
          f"{name}: nodes run {sorted(results)}, not {sorted(types)}")
    for nid, out in results.items():
        cls = NODE_CLASS_MAPPINGS[types[nid]]
        check(len(out) == len(cls.RETURN_TYPES) and all(
            o is not None for o in out),
            f"{name}: node #{nid} returned {out!r:.200}")
        check(not any(isinstance(o, Mesh) and o.num_faces == 0
                      for o in out), f"{name}: node #{nid}'s mesh is empty")
    order = [nid for nid in results]
    rec = {"s": total_s, "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches,
           "nodes": {node_span(nid, types[nid]): seconds[types[nid]].pop(0)
                     for nid in order}}
    log(f"workflow {name}: {total_s:.1f} s, launches {launches}; nodes "
        + ", ".join(f"{k} {v:.2f} s" for k, v in rec["nodes"].items()))
    return results, rec


def mvdiffusion_fit_path(dev, asset_dir, smi_line):
    """Phase 21: Wonder3D and Era3D (`Wonder3DConfig()`, `Era3DConfig()`
    with their CLIP towers, weights from seeds drawn on the card) and the
    multi-view mesh fit (`algorithms/diff_mesh.py`): a. card vs CPU at cut
    depth; b. Era3D at full width; c. Wonder3D at full width; d. the
    image → Era3D → fitted mesh graph; e. the analytic fit."""
    import copy as copy_
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.algorithms import diff_mesh
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.image import resize_images
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.models import clip
    from comfy3d_tpu_torch.models.diffusion.schedulers import make_scheduler
    from comfy3d_tpu_torch.models.era3d import Era3DConfig, Era3DPipeline
    from comfy3d_tpu_torch.models.wonder3d import (Wonder3DConfig,
                                                   Wonder3DPipeline)
    from comfy3d_tpu_torch.ops import mesh_render, rasterize

    cpu = torch.device("cpu")
    rec = {"card": smi_line}
    rng = np.random.RandomState(21)
    sm = MV_SMALL

    def cut(cfg):
        return dataclasses.replace(
            cfg, image_size=sm["image"], unet=dataclasses.replace(
                cfg.unet, layers_per_block=sm["layers_per_block"]),
            vae=dataclasses.replace(
                cfg.vae, layers_per_block=sm["layers_per_block"]))

    # a. the card against the port's CPU path at reduced depth, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    host_w = Wonder3DPipeline.init_random(0, cut(Wonder3DConfig()),
                                          device=cpu)
    host_e = Era3DPipeline.init_random(0, cut(Era3DConfig()), device=cpu)
    host_wv = vision_encoder_on(1, w3d_vision_config(
        layers=sm["clip_layers"]), cpu)
    host_ev = vision_encoder_on(2, era3d_vision_config(
        layers=sm["clip_layers"]), cpu)
    ecfg = host_e.cfg
    prompt = rng.randn(2 * ecfg.num_views, ecfg.prompt_tokens,
                       ecfg.prompt_dim).astype(np.float32)
    image_np = rng.rand(1, sm["image"], sm["image"], 3).astype(np.float32)
    lat = sm["image"] // 8
    x_np = rng.randn(2 * ecfg.num_views, 4, lat, lat).astype(np.float32)
    noise_np = rng.randn(1, ecfg.clip_embed_dim).astype(np.float32)
    sphere = uv_sphere(24, 48, 0.5, gate_texture())
    fs = sm["fit_size"]
    views_np = rng.rand(6, fs, fs, 3).astype(np.float32)
    masks_np = (rng.rand(6, fs, fs) > 0.3).astype(np.float32)
    fit_cfg = diff_mesh.DiffMeshConfig(texture_size=GATE_TEXTURE,
                                       lambda_normal=0.5)
    idx = torch.tensor([0, 3, 5])
    t_first = int(make_scheduler("DDIMScheduler", ecfg.scheduler,
                                 ERA3D_STEPS).timesteps[0])
    # the fit's step compared on the pixels both devices rasterize alike:
    # the float32 projection rounds differently on the card, and a pixel
    # that changes face or leaves the silhouette moves the gradients of the
    # texels it samples by a large share of the largest one
    faces = {}
    for d in (cpu, dev):
        cams = Camera.from_camposes(era3d_poses(), width=fs, height=fs,
                                    device=d)
        v, f = (torch.as_tensor(a, device=d) for a in (sphere.v, sphere.f))
        faces[d.type] = torch.stack([
            rasterize.rasterize(v, f, cams.view_proj[i], fs, fs,
                                method="binned").face_id.cpu()
            for i in range(len(cams.fovy_deg))])
    agree = (faces["cpu"] == faces[dev.type]).numpy()
    masks_np = masks_np * agree
    outs = {}
    for d in (cpu, dev):
        th = time.perf_counter()
        w, e = pipe_on(host_w, d), pipe_on(host_e, d)
        w.set_vision_encoder(clip.make_vision_conditioner(
            copy_.deepcopy(host_wv).to(d)))
        e.set_vision_encoder(clip.make_vision_conditioner(
            copy_.deepcopy(host_ev).to(d)))
        e.set_prompt_embeds(prompt)
        img = torch.as_tensor(image_np, device=d)
        x = torch.as_tensor(x_np, device=d)
        with torch.no_grad():
            emb, w_lat = w.conditioning(img)
            ce = w.camera_class_emb()
            cond = e.conditioning(img, noise_np)
            e_eps, (ele, focal) = e.guided_eps(x, t_first, cond,
                                               ERA3D_GUIDANCE)
            o = {"w3d_embedding": emb, "w3d_image_latent": w_lat,
                 "w3d_eps_g1": w.guided_eps(x, t_first, emb, w_lat, ce,
                                            1.0),
                 "w3d_eps_g2": w.guided_eps(x, t_first, emb, w_lat, ce,
                                            2.0),
                 "era3d_class_emb": cond.class_emb,
                 "era3d_eps": e_eps, "era3d_elevation": ele,
                 "era3d_focal": focal}
        cams = Camera.from_camposes(era3d_poses(), width=fs, height=fs,
                                    device=d)
        fit = diff_mesh.MeshFit(sphere, cams, views_np, masks_np, fit_cfg)
        params = fit.init_params()
        loss = fit.loss(params, idx.to(d))
        loss.backward()
        o.update(fit_loss=loss.detach(),
                 fit_grad_offsets=params["offsets"].grad,
                 fit_grad_albedo=params["raw_albedo"].grad)
        if d.type == "cuda":
            torch.cuda.synchronize()
        outs[d.type] = o
        outs[d.type + "_s"] = time.perf_counter() - th
        del w, e, fit, params
    parity = {"cut": sm, "t": t_first, "host_s": outs["cpu_s"],
              "card_s": outs[dev.type + "_s"],
              "fit_face_id_disagree": int((~agree).sum()),
              "fit_face_id_agree_share": float(agree.mean())}
    for k, ref in outs["cpu"].items():
        parity[f"{k}_rel_err"] = rel_err(outs[dev.type][k], ref)
    log(f"mvdiffusion a. card vs CPU (TF32 off): {parity}")
    check(parity["fit_face_id_agree_share"] >= MR_FACE_AGREE,
          f"the fit's face ids agree on {parity['fit_face_id_agree_share']}"
          " of the pixels")
    for k in outs["cpu"]:
        check(parity[f"{k}_rel_err"] <= TOL_MV_REL,
              f"mvdiffusion {k}: card vs CPU {parity[k + '_rel_err']:.3g} "
              "of the largest value")
    rec["card_vs_cpu"] = parity
    del outs, host_w, host_e, host_wv, host_ev
    rec["a_s"] = time.perf_counter() - t0

    image = crm_reference(512)

    def sized(img, size):
        """[1, size, size, 3] on the card, as the pipelines resize it."""
        return resize_images(torch.as_tensor(img, device=dev)[None], size,
                             size)

    # b. Era3D at Era3DConfig(): 512², 6 views, SD-2.1-unclip widths
    t0 = time.perf_counter()
    reset_launches()
    enc = vision_encoder_on(2, era3d_vision_config(), dev)
    era = Era3DPipeline.init_random(0, Era3DConfig(), device=dev)
    era.set_vision_encoder(clip.make_vision_conditioner(enc))
    ecfg = era.cfg
    era.set_prompt_embeds(rng.randn(2 * ecfg.num_views, ecfg.prompt_tokens,
                                    ecfg.prompt_dim).astype(np.float32))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    clip_ms = cuda_ms(lambda: era.vision_encoder(image), 5)
    sched = make_scheduler(era.scheduler_name, ecfg.scheduler, ERA3D_STEPS)
    with torch.no_grad():
        cond = era.conditioning(sized(image, ecfg.image_size),
                                torch.zeros(1, ecfg.clip_embed_dim))
    x0 = torch.randn((2 * ecfg.num_views, 4, ecfg.image_size // 8,
                      ecfg.image_size // 8),
                     generator=torch.Generator().manual_seed(3)).to(dev)
    te = int(sched.timesteps[0])

    def era3d_step():
        with torch.no_grad():
            return sched.step(era.guided_eps(x0, te, cond,
                                             ERA3D_GUIDANCE)[0], 0, x0)

    rec["era3d"], e_colors, e_normals = _mv_stage(
        "b. Era3D", era, image, ERA3D_TIMED_STEPS, ERA3D_GUIDANCE,
        ERA3D_SEED, era3d_step, tf32_sampler=False, node_steps=ERA3D_STEPS)
    with torch.no_grad():
        _, (ele, focal) = era.guided_eps(x0, te, cond, ERA3D_GUIDANCE)
    rec["era3d"].update(
        init_s=init_s, clip_ms=clip_ms, clip_params=count_params(enc),
        unet_frames=4 * ecfg.num_views, latent=ecfg.image_size // 8,
        pose_aux={"elevation": ele.flatten().tolist(),
                  "focal": focal.flatten().tolist()})
    check(all(math.isfinite(v) for v in rec["era3d"]["pose_aux"]
              ["elevation"] + rec["era3d"]["pose_aux"]["focal"]),
          "Era3D's regressed pose")
    rec["era3d"]["launches"] = read_launches()
    del era, enc, cond, x0
    torch.cuda.empty_cache()
    rec["b_s"] = time.perf_counter() - t0

    # c. Wonder3D at Wonder3DConfig(): 256², 6 views, SD-1.5-class widths
    t0 = time.perf_counter()
    reset_launches()
    enc = vision_encoder_on(1, w3d_vision_config(), dev)
    w3d = Wonder3DPipeline.init_random(0, Wonder3DConfig(), device=dev)
    w3d.set_vision_encoder(clip.make_vision_conditioner(enc))
    wcfg = w3d.cfg
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sched = make_scheduler(w3d.scheduler_name, wcfg.scheduler, W3D_STEPS)
    with torch.no_grad():
        emb, w_lat = w3d.conditioning(sized(image, wcfg.image_size))
        ce = w3d.camera_class_emb()
    x0 = torch.randn((2 * wcfg.num_views, 4, wcfg.image_size // 8,
                      wcfg.image_size // 8),
                     generator=torch.Generator().manual_seed(4)).to(dev)
    tw = int(sched.timesteps[0])

    def w3d_step(g=W3D_GUIDANCE):
        with torch.no_grad():
            return sched.step(w3d.guided_eps(x0, tw, emb, w_lat, ce, g), 0,
                              x0)

    rec["wonder3d"], w_colors, _ = _mv_stage(
        "c. Wonder3D", w3d, image, W3D_STEPS, W3D_GUIDANCE, W3D_SEED,
        w3d_step, tf32_sampler=True, node_steps=W3D_STEPS)
    rec["wonder3d"].update(
        init_s=init_s, clip_params=count_params(enc),
        unet_frames=2 * wcfg.num_views, latent=wcfg.image_size // 8,
        step_ms_cfg2=cuda_ms(lambda: w3d_step(2.0), 3, warmup=1),
        step_tflop_cfg2=flops_of(lambda: w3d_step(2.0)) / 1e12,
        launches=read_launches())
    del w3d, enc, emb, w_lat, x0
    torch.cuda.empty_cache()
    rec["c_s"] = time.perf_counter() - t0

    # d. LoadImage → Era3D → masks from the normals → the UV sphere fitted
    # at the fit node's defaults (512² views, batch 3, texture 512), cut to
    # FIT_ITERS steps with one remesh; the remesh and each segment timed
    t0 = time.perf_counter()
    uv_sphere(64, 128, 0.5).write(os.path.join(asset_dir, "uv_sphere.glb"))
    seg_s, remesh = [], []
    fit_seg, fit_remesh = diff_mesh._fit_segment, diff_mesh._periodic_remesh

    def timed_segment(*a, **kw):
        t = time.perf_counter()
        out = fit_seg(*a, **kw)
        torch.cuda.synchronize()
        seg_s.append((a[5], time.perf_counter() - t))
        return out

    def timed_remesh(mesh, cfg):
        t = time.perf_counter()
        out = fit_remesh(mesh, cfg)
        remesh.append(dict(s=time.perf_counter() - t, nf_in=mesh.num_faces,
                           nf_out=out.num_faces, nv_out=out.num_vertices))
        return out

    diff_mesh._fit_segment, diff_mesh._periodic_remesh = (timed_segment,
                                                          timed_remesh)
    try:
        results, graph = timed_graph(
            "era3d_fit", config_graph("era3d_fit"),
            {4: {"num_inference_steps": FIT_GRAPH_STEPS},
             7: {"training_iterations": FIT_ITERS,
                 "remesh_after_n_iteration": FIT_REMESH}}, device=dev)
    finally:
        diff_mesh._fit_segment = fit_seg
        diff_mesh._periodic_remesh = fit_remesh
    check(not any(graph["launches"].values()),
          f"the Era3D fit graph launched a compositor kernel: "
          f"{graph['launches']}")
    views, normals, poses = results[4]
    masks = results[5][0]
    fitted = results[7][0]
    check(len(remesh) == 1 and [s[0] for s in seg_s]
          == [FIT_REMESH, FIT_ITERS - FIT_REMESH],
          f"the fit's segments {seg_s} and remeshes {remesh}")
    check(fitted.albedo is not None and fitted.albedo.shape == (512, 512, 3)
          and np.isfinite(fitted.v).all()
          and fitted.vt is not None, "the fitted mesh")
    glb = os.path.join(asset_dir, WF_DIR, "era3d_fit_mesh.glb")
    back = Mesh.load(glb)
    # GLB welds (position, UV) pairs: the corners keep their positions
    check(back.num_faces == fitted.num_faces and np.allclose(
        back.v[back.f], fitted.v[fitted.f], atol=1e-6),
        "GLB round trip changed the mesh")
    # the fit's step on the graph's views, profiled alone
    cams = Camera.from_camposes(poses, fovy_deg=49.1, width=views.shape[2],
                                height=views.shape[1], device=dev)
    fcfg = diff_mesh.DiffMeshConfig(texture_size=512)
    mesh0 = Mesh.load(os.path.join(asset_dir, "uv_sphere.glb"))
    problem = diff_mesh.MeshFit(mesh0, cams, views, masks, fcfg)
    params = problem.init_params()
    opt = torch.optim.Adam([{"params": [params["offsets"]], "lr": 1e-3},
                            {"params": [params["raw_albedo"]], "lr": 0.1}])
    sel = torch.tensor([0, 2, 4], device=dev)

    def fit_step():
        opt.zero_grad(set_to_none=True)
        loss = problem.loss(params, sel)
        loss.backward()
        opt.step()

    step_prof = profile_frames(fit_step, FIT_PROFILE_STEPS)
    step_prof["device_idle_share"] = 1.0 - step_prof["device_union_ms"] \
        / step_prof["window_ms"]
    torch.cuda.synchronize()
    ts = time.perf_counter()
    for _ in range(FIT_PROFILE_STEPS):
        fit_step()
    torch.cuda.synchronize()
    graph.update(
        era3d_steps=FIT_GRAPH_STEPS, fit_iterations=FIT_ITERS,
        remesh_after=FIT_REMESH, segments=[dict(steps=n, s=s)
                                           for n, s in seg_s],
        step_s=[s / n for n, s in seg_s], remesh=remesh[0],
        masks_mean=float(masks.mean()), nv=fitted.num_vertices,
        nf=fitted.num_faces, glb_bytes=os.path.getsize(glb),
        fit_step={"ms": (time.perf_counter() - ts) * 1e3
                  / FIT_PROFILE_STEPS, "faces": mesh0.num_faces,
                  "profile": {k: v for k, v in step_prof.items()
                              if k != "top"},
                  "profile_top": step_prof["top"][:6]})
    rec["graph"] = graph
    log(f"mvdiffusion d. graph: {graph}")
    del results, problem, params, opt, views, normals
    torch.cuda.empty_cache()
    rec["d_s"] = time.perf_counter() - t0

    # e. the analytic fit: a textured UV sphere's six Era3D views, fitted
    # from a copy scaled by GATE_SCALE with a flat grey texture
    t0 = time.perf_counter()
    true = uv_sphere(24, 48, 0.5, gate_texture())
    cams = Camera.from_camposes(era3d_poses(), fovy_deg=49.1,
                                width=GATE_SIZE, height=GATE_SIZE,
                                device=dev)

    def render(m):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        with torch.no_grad():
            return mesh_render.render_mesh(t(m.v), t(m.f), cams, vt=t(m.vt),
                                           ft=t(m.ft), albedo=t(m.albedo))

    target = render(true)
    start = dataclasses.replace(
        true, v=true.v * GATE_SCALE,
        albedo=np.full_like(true.albedo, 0.5))

    def scores(m):
        out = render(m)
        a = target["alpha"][..., None]
        mse = float((((out["image"] - target["image"]) * a) ** 2).mean())
        return (10.0 * math.log10(1.0 / max(mse, 1e-20)),
                float(np.linalg.norm(m.v - true.v, axis=1).mean()))

    losses = []
    gcfg = diff_mesh.DiffMeshConfig(iterations=GATE_ITERS, batch_size=3,
                                    texture_size=GATE_TEXTURE,
                                    lr_verts=GATE_LR_VERTS)
    tf = time.perf_counter()
    fitted = diff_mesh.fit(start, cams, target["image"], target["alpha"],
                           gcfg, progress=lambda i, r: losses.append(
                               (i, r["loss"])))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tf
    (db0, err0), (db1, err1) = scores(start), scores(fitted)
    gate = {"size": GATE_SIZE, "iterations": GATE_ITERS,
            "scale": GATE_SCALE, "lr_verts": GATE_LR_VERTS,
            "faces": true.num_faces, "psnr_db": [db0, db1],
            "vertex_err": [err0, err1], "loss": losses, "fit_s": fit_s,
            "step_ms": fit_s * 1e3 / GATE_ITERS}
    log(f"mvdiffusion e. analytic fit: {gate}")
    check(db1 >= db0 + GATE_PSNR_GAIN_DB,
          f"analytic fit: PSNR {db0:.2f} → {db1:.2f} dB")
    check(err1 <= GATE_VERT_SHRINK * err0,
          f"analytic fit: vertex error {err0:.4f} → {err1:.4f}")
    check(losses[-1][1] < losses[0][1], f"analytic fit: loss {losses}")
    rec["analytic_fit"] = gate
    rec["e_s"] = time.perf_counter() - t0
    return rec


# ------------------------------------------------------------------ #
# 22. FlexiCubes multi-view depth → mesh (the soft-silhouette kernels)
# ------------------------------------------------------------------ #
SIL_SIGMA = 3e-4         # SDFFitConfig.sigma_sil
SIL_RES, SIL_SIZE = 64, 256   # 22a: the training surface's grid, the view
TOL_SIL = 1e-5           # coverage, kernel vs plain (absolute; f32 sums of
#                          up to 10^5 terms in another order)
TOL_SIL_GRAD_REL = 1e-3  # vertex gradients, kernel vs plain, of their max
#                          (each a sum over up to 2.6e5 pixels, by atomics in
#                          the kernel; TOL_BWD_REL's bound)
# f32 operations of one face-pixel pair (three segment distances at 17,
# three edge functions at 3, the min, sqrt and sigmoid argument), more per
# live pair (sigmoid argument >= -87: the sigmoid, clip, log1p and sum),
# and more per live pair in the backward (the nearest segment's gradient,
# the warp sums). A dead pair adds nothing to the f32 sum nor to a
# gradient, so the bounds count live pairs only; the kernels' walk of
# every pair is kept beside them (`_full_walk`)
SIL_PAIR_OPS = 68
SIL_LIVE_OPS = 8
SIL_BWD_LIVE_OPS = 20
FC_SIZE = 512            # 22b: the Mesh_Orbit_Renderer node's default
FC_MESH_RADIUS = 0.55    # 22b: the source sphere
FC_ITERS = 10            # 22b: training_iterations (the node's default 512)
SIL_PLAIN_CHUNK = 256    # faces a step of the plain version on the card
FC_RES = 128             # 22b: voxel_grids_resolution (the node's default)
FC_PROFILE_STEPS = 1
FC_TETS_RES = 128        # 22c: SDFFitConfig(engine="tets")'s grid
# 23a: the full config's parameters (tests/test_torch_triposg.py holds them
# against the JAX package's by shape: its VAE without the encoder, its
# DINOv2 without HF's mask_token)
TRIPOSG_PARAMS = {"dit": 1_439_556_160, "vae": 242_662_017,
                  "cond": 304_368_640}


def silhouette_pairs(tri, ok, size, sigma=SIL_SIGMA, block=64):
    """(face-pixel pairs, live pairs) of the soft silhouette on these
    inputs: every ok face against every pixel, and those whose sigmoid
    argument is at least -87 (the kernel's transcendental work)."""
    import torch
    from comfy3d_tpu_torch.ops import rasterize as R
    t = tri[ok].detach()
    px = R._pixel_centers(size, size, t.device).reshape(-1, 1, 2)
    scale = 1.0 / size
    live = 0
    with torch.no_grad():
        for i in range(0, t.shape[0], block):
            c = t[i:i + block]
            d = R._signed_dist_to_tri(px, c[:, 0], c[:, 1], c[:, 2]) * scale
            live += int((torch.sign(d) * d * d / sigma >= -87.0).sum())
    return t.shape[0] * size * size, live


def silhouette_bounds(tri, ok, size):
    """The forward's and backward's bounds (`_bound`) on these inputs: the
    live pairs' operations (`silhouette_pairs`), each face's corners and
    flag read and the coverage written (the backward: the upstream
    gradient read, each corner's gradient written); with the walk of every
    pair beside them (`_full_walk`)."""
    pairs, live = silhouette_pairs(tri, ok, size)
    nf = int(tri.shape[0])
    fwd_pair = SIL_PAIR_OPS + SIL_LIVE_OPS
    bwd_pair = fwd_pair + SIL_BWD_LIVE_OPS
    return (dict(_bound(nf * 25, size * size * 4, live * fwd_pair,
                        pairs=pairs, live_pairs=live),
                 **_full_walk(pairs * SIL_PAIR_OPS + live * SIL_LIVE_OPS)),
            dict(_bound(nf * 25 + size * size * 4, nf * 24, live * bwd_pair,
                        pairs=pairs, live_pairs=live),
                 **_full_walk(pairs * SIL_PAIR_OPS
                              + live * (SIL_LIVE_OPS + SIL_BWD_LIVE_OPS))))


def silhouette_vs_plain(label, flat, faces, mvp, size, seed):
    """The soft silhouette on the card through the kernels against its
    plain version (`SIL_PLAIN_CHUNK` faces a step) on the same vertices:
    coverage and vertex gradients of a seeded cotangent; the kernels'
    times by CUDA events, the plain version's forward and backward on the
    host's clock between synchronisations (one pass); the bounds."""
    import torch
    from comfy3d_tpu_torch.ops import rasterize as R
    g = torch.Generator(flat.device).manual_seed(seed)
    cot = torch.randn((size, size), generator=g, device=flat.device)
    out, grads, pass_ms = {}, {}, {}
    for name, fn in (("kernel", R.soft_silhouette),
                     ("plain", R.soft_silhouette_plain)):
        v = flat.detach().clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cov = fn(v, faces, mvp, size, size, sigma=SIL_SIGMA,
                 chunk=SIL_PLAIN_CHUNK)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (cov * cot).sum().backward()
        torch.cuda.synchronize()
        pass_ms[name] = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
        out[name], grads[name] = cov.detach(), v.grad
    err = float((out["kernel"] - out["plain"]).abs().max())
    gmax = float(grads["plain"].abs().max())
    gerr = float((grads["kernel"] - grads["plain"]).abs().max())
    check(bool(torch.isfinite(grads["kernel"]).all()),
          f"{label}: non-finite silhouette gradient")
    check(err <= TOL_SIL, f"{label}: coverage kernel vs plain {err}")
    check(gerr <= TOL_SIL_GRAD_REL * gmax,
          f"{label}: vertex gradients kernel vs plain {gerr} of {gmax}")
    tri, ok = R._face_screen(flat.detach(), faces, mvp, size, size, None)
    g_l = -(1.0 - out["kernel"]) * cot
    rec = dict(faces=int(faces.shape[0]), ok_faces=int(ok.sum()), size=size,
               max_abs_err=err, grad_max_abs_err=gerr,
               grad_max_rel_err=gerr / max(gmax, 1e-30), grad_max=gmax,
               coverage_mean=float(out["kernel"].mean()),
               fwd_ms=cuda_ms(lambda: R.soft_silhouette_fwd(
                   tri, ok, size, size, SIL_SIGMA), 5, warmup=1),
               bwd_ms=cuda_ms(lambda: R.soft_silhouette_bwd(
                   tri, ok, g_l, size, size, SIL_SIGMA), 5, warmup=1),
               plain_fwd_ms=pass_ms["plain"][0],
               plain_bwd_ms=pass_ms["plain"][1],
               plain_chunk=SIL_PLAIN_CHUNK, pass_ms=pass_ms)
    rec["fwd_bound"], rec["bwd_bound"] = silhouette_bounds(tri, ok, size)
    log(f"22 silhouette {label}: {rec}")
    return rec


def chamfer(a, b, block=8192):
    """Symmetric Chamfer distance of two point sets on the card: the mean
    nearest-point distance each way, averaged; and the two ways."""
    import torch

    def one_way(p, q):
        return float(torch.cat([torch.cdist(p[i:i + block], q).amin(1)
                                for i in range(0, p.shape[0], block)]).mean())
    ab, ba = one_way(a, b), one_way(b, a)
    return 0.5 * (ab + ba), ab, ba


def flexicubes_path(dev, asset_dir, smi_line):
    """Phase 22: FlexiCubes multi-view depth → mesh (`algorithms/sdf_fit.py`,
    the soft-silhouette kernels): a. the kernels against their plain
    version on one view of a res-64 training surface at 256²; b. a sphere's
    8-view orbit renders at 512² → FlexiCubes_MVS at its defaults through
    `run_workflow` (FC_ITERS steps), with the kernels held against the
    plain version again at the graph's shapes; c. one step of
    `engine="tets"` at 128³."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.algorithms import sdf_fit
    from comfy3d_tpu_torch.core.camera import Camera
    from comfy3d_tpu_torch.core.mesh import Mesh
    from comfy3d_tpu_torch.nodes import NODE_CLASS_MAPPINGS
    from comfy3d_tpu_torch.ops import flexicubes as FC
    from comfy3d_tpu_torch.ops import mesh_render, tetra

    rec = {"card": smi_line}

    # a. the kernels against the plain version: a res-64 training surface
    # (the initial sphere, its grid deformed and weights drawn from a seed)
    t0 = time.perf_counter()
    cfg = sdf_fit.SDFFitConfig(resolution=SIL_RES)
    params, grid, _ = sdf_fit.init_params(cfg, device=dev)
    g = torch.Generator(dev).manual_seed(22)
    with torch.no_grad():
        v = grid + (0.3 * 2.0 / SIL_RES) * torch.randn(
            grid.shape, generator=g, device=dev)
        w = 0.5 * torch.randn(params["weights"].shape, generator=g,
                              device=dev)
        vd, _, faces, _, _ = FC.flexicubes(params["sdf"], v, SIL_RES,
                                           weights=w, training=True)
        flat = vd[faces].reshape(-1, 3).contiguous()
    tri_faces = torch.arange(flat.shape[0], device=dev,
                             dtype=torch.int32).reshape(-1, 3)
    cam = Camera.from_orbit([15.0], [30.0], MR_RADIUS, width=SIL_SIZE,
                            height=SIL_SIZE, device=dev)
    rec["a"] = silhouette_vs_plain("22a", flat, tri_faces, cam.view_proj[0],
                                   SIL_SIZE, 1)
    rec["a"]["s"] = time.perf_counter() - t0
    del params, grid, v, w, vd, faces, flat, tri_faces
    torch.cuda.empty_cache()

    # b. the graph: a sphere's orbit renders → FlexiCubes_MVS
    t0 = time.perf_counter()
    src = uv_sphere(32, 64, FC_MESH_RADIUS)
    src = Mesh(v=src.v, f=src.f)
    src.write(os.path.join(asset_dir, "fc_sphere.glb"))
    orbit = _orbit(2, MR_RADIUS)
    poses = NODE_CLASS_MAPPINGS[orbit[1]]().stack_poses(*orbit[2])[0]
    cams = Camera.from_camposes(poses, fovy_deg=49.1, width=FC_SIZE,
                                height=FC_SIZE, device=dev)
    with torch.no_grad():
        dmax = float(mesh_render.render_mesh(
            torch.as_tensor(src.v, device=dev),
            torch.as_tensor(src.f, device=dev), cams)["depth"].max())
    steps, surf, fits = [], {}, []
    step, mesh_fn = sdf_fit.SDFFit.step, sdf_fit.SDFFit.mesh

    def timed_step(self, view_idx):
        if not fits:
            fits.append(self)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(self, view_idx)
        steps.append((float(loss), (time.perf_counter() - t) * 1e3))
        return loss

    def timed_mesh(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        soup = self.surface_soup()
        surf["extract_s"] = time.perf_counter() - t
        t = time.perf_counter()
        v, f = tetra.weld(soup, soup.shape[0])
        surf["weld_s"] = time.perf_counter() - t
        surf["soup_triangles"] = int(soup.shape[0])
        return Mesh(v=v, f=f).auto_normal()

    sdf_fit.SDFFit.step, sdf_fit.SDFFit.mesh = timed_step, timed_mesh
    try:
        graph = config_graph("flexicubes", fit_size=FC_SIZE,
                             depth_range=(0.0, dmax))
        results, graph_rec = timed_graph(
            "flexicubes", graph, {4: {"training_iterations": FC_ITERS,
                                      "voxel_grids_resolution": FC_RES}},
            device=dev)
    finally:
        sdf_fit.SDFFit.step, sdf_fit.SDFFit.mesh = step, mesh_fn
    fitted = results[4][0]
    losses = [x[0] for x in steps]
    step_ms = sorted(x[1] for x in steps[1:])
    check(len(steps) == FC_ITERS, f"22b: {len(steps)} fit steps")
    renders = results[3]
    masks = renders[1].to(dev)
    depths = renders[2][..., 0].to(dev) * dmax * (masks > 0.5)
    normals = renders[3].to(dev)
    fit_cfg = fits[0].cfg
    problem = sdf_fit.SDFFit(cams, masks, depths, normals, fit_cfg)
    all_views = np.arange(len(poses))
    with torch.no_grad():
        loss_init = float(problem.loss(problem.params, all_views))
        loss_fit = float(fits[0].loss(fits[0].params, all_views))
    check(loss_fit < loss_init, f"22b: the loss over the {len(poses)} "
          f"views did not fall: {loss_init} → {loss_fit}")
    del fits[:]
    init_mesh = problem.mesh()
    src_pts = torch.as_tensor(src.v, device=dev)
    ch_init, *ch_init_ways = chamfer(
        torch.as_tensor(init_mesh.v, device=dev), src_pts)
    ch_fit, *ch_fit_ways = chamfer(torch.as_tensor(fitted.v, device=dev),
                                   src_pts)
    log(f"22b: Chamfer {ch_init} {ch_init_ways} → {ch_fit} {ch_fit_ways}; "
        f"loss over the views {loss_init} → {loss_fit}")
    check(ch_fit < ch_init, f"22b: Chamfer {ch_fit} not below the initial "
          f"sphere's {ch_init}")
    # the kernels against the plain version at the graph's shapes: the
    # initial training surface, view 0
    with torch.no_grad():
        tris, _ = problem.geometry(problem.params)
        flat = tris.reshape(-1, 3).contiguous()
    tri_faces = torch.arange(flat.shape[0], device=dev,
                             dtype=torch.int32).reshape(-1, 3)
    main = silhouette_vs_plain("22b", flat, tri_faces, cams.view_proj[0],
                               FC_SIZE, 2)
    del tris, flat, tri_faces
    views = np.array([0, 2, 4, 6])
    prof = profile_frames(lambda: problem.step(views), FC_PROFILE_STEPS,
                          match=("silhouette",))
    median_ms = step_ms[len(step_ms) // 2]
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / median_ms
    rec["b"] = dict(
        graph=graph_rec, iterations=FC_ITERS, depth_max=dmax,
        launches=graph_rec["launches"], loss_all_views_initial=loss_init,
        loss_all_views_fitted=loss_fit, step_losses=losses,
        chamfer_initial_ways=ch_init_ways, chamfer_fitted_ways=ch_fit_ways,
        step_ms_median=median_ms,
        step_ms_min=step_ms[0], step_ms_max=step_ms[-1],
        peak_bytes=graph_rec["peak_bytes"], chamfer_initial=ch_init,
        chamfer_fitted=ch_fit, fitted_vertices=fitted.num_vertices,
        fitted_faces=fitted.num_faces, **surf,
        profile={k: v for k, v in prof.items() if k != "top"},
        top=prof["top"], main_shape=main, s=time.perf_counter() - t0)
    want = FC_ITERS * 4
    check(graph_rec["launches"]["soft_silhouette_fwd"] == want
          and graph_rec["launches"]["soft_silhouette_bwd"] == want,
          f"22b: silhouette launches {graph_rec['launches']}, not {want}")
    del problem, results, renders
    torch.cuda.empty_cache()

    # c. the first step of the marching-tets engine at 128³ (no warm-up:
    # its allocations are in the time), its launches counted
    t0 = time.perf_counter()
    reset_launches()
    tets_cfg = dataclasses.replace(fit_cfg, resolution=FC_TETS_RES,
                                   engine="tets")
    tets = sdf_fit.SDFFit(cams, masks, depths, normals, tets_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss = float(tets.step(views))
    torch.cuda.synchronize()
    rec["c"] = dict(first_step_ms=(time.perf_counter() - t) * 1e3,
                    loss=loss,
                    tets=int(tets.tets.shape[0]), launches=read_launches(),
                    peak_bytes=torch.cuda.max_memory_allocated(),
                    s=time.perf_counter() - t0)
    check(np.isfinite(loss), "22c: non-finite loss")
    del tets
    torch.cuda.empty_cache()
    log(f"phase 22: {rec}")
    return rec


# ------------------------------------------------------------------ #
# 23. TripoSG image / scribble → mesh
# ------------------------------------------------------------------ #
TOL_TSG_REL = 1e-3       # card vs CPU, of the largest value, TF32 off
TSG_SMALL = dict(dit_layers=3, vae_layers=2, cond_layers=2, dense=32)
TSG_STEPS = 50           # TripoSG_I23D_Model's defaults
TSG_GUIDANCE = 7.0
TSG_SEED = 42
TSG_OCTREE = 256         # dense_octree_depth 8
SCRIBBLE_STEPS = 16      # TripoSG_Scribble_Model's default


def triposg_path(dev, asset_dir, smi_line):
    """Phase 23, at `TripoSGConfig()` (DINOv2-L at 518², the DiT of 21
    blocks at width 2,048 on 2,048 latents, the VAE decoder of 16 blocks at
    1,024) with the nodes' defaults: a. the full config's parameter counts
    on `meta`; b. the card against the port's CPU path at cut depth; c. the
    image graph with weights drawn on the card, then the pipeline's step,
    decode and extraction timed; d. the scribble graph. Runs under
    `torch.no_grad()`."""
    import dataclasses

    import numpy as np
    import torch
    from comfy3d_tpu_torch.models.triposg import (TripoSG, TripoSGConfig,
                                                  TripoSGPipeline)
    from comfy3d_tpu_torch.models.vecset import vae as V
    from comfy3d_tpu_torch.ops.tetra import EXTRACT_SPANS

    cfg = TripoSGConfig()
    rec = {"card": smi_line, "config": dataclasses.asdict(cfg)}
    cpu = torch.device("cpu")

    # a. the parameter counts on meta
    with torch.device("meta"):
        meta = TripoSG(cfg)
    params = {name: count_params(getattr(meta, name))
              for name in ("dit", "vae", "cond")}
    del meta
    check(params == TRIPOSG_PARAMS,
          f"parameters {params}, not {TRIPOSG_PARAMS}")
    rec["params"] = params

    # b. the card against the port's CPU path at cut depth, TF32 off
    t0 = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    sm = TSG_SMALL
    small = dataclasses.replace(
        cfg, dit=dataclasses.replace(cfg.dit, num_layers=sm["dit_layers"]),
        vae=dataclasses.replace(cfg.vae,
                                num_layers_decoder=sm["vae_layers"]),
        cond=dataclasses.replace(cfg.cond, layers=sm["cond_layers"]))
    image = white_composite(cfg.image_size)[0]
    gen = torch.Generator().manual_seed(23)
    shape = (1, cfg.vae.num_latents, cfg.vae.latent_channels)
    noise = torch.randn(shape, generator=gen)
    x2 = torch.randn((2,) + shape[1:], generator=gen)
    pts = torch.rand((1, 4096, 3), generator=gen) * 2.0 - 1.0
    host = TripoSGPipeline.init_random(0, small, device=cpu)
    outs = {}
    for d in (cpu, dev):
        pipe = pipe_on(host, d)
        cond = pipe.encode_cond(image)
        decoded = pipe.model.vae(noise.to(d))
        o = {"encode_cond": cond,
             "dit": pipe.model.dit(x2.to(d), torch.full((2,), 500.0,
                                                        device=d), cond),
             "two_steps": pipe.sample_latents(image, num_steps=2,
                                              guidance_scale=TSG_GUIDANCE,
                                              draws=noise),
             "conditional_two_steps": pipe.sample_latents(
                 image, num_steps=2, draws=noise, distilled=True),
             "vae_decoder": decoded,
             "query": pipe.model.vae.query(decoded, pts.to(d)),
             "dense_decode": V.decode_volume(pipe.model.vae.query, decoded,
                                             octree_resolution=sm["dense"],
                                             bounds=1.005)}
        torch.cuda.synchronize()
        outs[d.type] = o
        del pipe
    parity = dict(sm)
    for k, ref in outs["cpu"].items():
        parity[f"{k}_rel_err"] = rel_err(outs[dev.type][k], ref)
    log(f"triposg b. card vs CPU (cut depth, TF32 off): {parity}")
    for k in outs["cpu"]:
        check(parity[f"{k}_rel_err"] <= TOL_TSG_REL,
              f"triposg {k}: card vs CPU {parity[k + '_rel_err']:.3g} of the "
              "largest value")
    rec["card_vs_cpu"] = parity
    del outs, host, decoded
    rec["b_s"] = time.perf_counter() - t0

    # c. the image graph at the node's defaults (the loader draws the full
    # config on the card), then the loader's pipeline alone, timed
    t0 = time.perf_counter()
    res, graph = timed_graph("triposg", config_graph("triposg"), device=dev)
    check(not any(graph["launches"].values()),
          f"the TripoSG path launched a kernel: {graph['launches']}")
    mesh = res[4][0]
    check(mesh.num_faces > 0 and bool(np.isfinite(mesh.v).all()),
          "the TripoSG mesh is empty or not finite")
    graph.update(vertices=mesh.num_vertices, triangles=mesh.num_faces)
    pipe = res[3][0]
    check(isinstance(pipe, TripoSGPipeline) and pipe.cfg == cfg,
          "the loader's pipeline is not the full config")
    del res
    torch.cuda.empty_cache()
    cond = pipe.encode_cond(image)
    x = noise.to(dev)
    xx = torch.cat([x, x])
    tt = torch.full((2,), 500.0, device=dev)

    def one_step():
        return pipe.model.dit(xx, tt, cond)

    step_ms = cuda_ms(one_step, 3, warmup=1)
    step_tf32_ms = tf32_ms(one_step, 2)
    step_flops = flops_of(one_step)
    lat = pipe.denoise(cond, x, TSG_GUIDANCE, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    td = time.perf_counter()
    grid = pipe.decode_grid(lat, TSG_OCTREE)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - td) * 1e3
    decode_peak = torch.cuda.max_memory_allocated()
    extracted, extract_s, spans, _ = profile_spans(
        lambda: V.grid_to_mesh(grid[0], bounds=1.005), EXTRACT_SPANS)
    rec["c"] = dict(
        graph=graph, guided_step_ms=step_ms, guided_step_tf32_ms=step_tf32_ms,
        guided_step_flops=step_flops, tokens=2 * (cfg.vae.num_latents + 1),
        context_tokens=int(cond.shape[1]),
        steps_ms_estimate=step_ms * TSG_STEPS, decode_ms=decode_ms,
        decode_peak_bytes=decode_peak, extract_s=extract_s,
        extract_spans=spans, extracted_triangles=extracted.num_faces,
        grid_inside_share=float((grid > 0).float().mean()),
        s=time.perf_counter() - t0)
    log(f"triposg c: {rec['c']}")
    del pipe, cond, grid, lat
    torch.cuda.empty_cache()

    # d. the scribble graph at its defaults (16 steps, the conditional pass)
    t0 = time.perf_counter()
    res, graph = timed_graph("triposg_scribble",
                             config_graph("triposg_scribble"), device=dev)
    mesh = res[3][0]
    check(mesh.num_faces > 0 and bool(np.isfinite(mesh.v).all()),
          "the scribble mesh is empty or not finite")
    check(not any(graph["launches"].values()),
          f"the scribble path launched a kernel: {graph['launches']}")
    graph.update(vertices=mesh.num_vertices, triangles=mesh.num_faces)
    rec["d"] = dict(graph=graph, steps=SCRIBBLE_STEPS,
                    s=time.perf_counter() - t0)
    rec["launches"] = graph["launches"]
    del res
    torch.cuda.empty_cache()
    log(f"phase 23: {rec}")
    return rec


def main(out_path=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from comfy3d_tpu_torch.core.camera import Camera, compose_orbit_camposes
    from comfy3d_tpu_torch.core.io.ply import load_gs_ply, save_gs_ply
    from comfy3d_tpu_torch.ops import _build, gs_flat
    from comfy3d_tpu_torch.ops import gs_render as G

    # the plain versions' einsum is a matmul: keep it in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}
    phase_s = {}
    t_lap = [time.perf_counter()]

    def lap(name):
        """Seconds since the last lap, under `name` (phases in order)."""
        now = time.perf_counter()
        phase_s[name] = now - t_lap[0]
        t_lap[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    # 1. the card
    card = torch.cuda.get_device_name(0)
    smi_line = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    log(f"device {card} | nvidia-smi: {smi_line}, SM clock max {clock_mhz} "
        f"MHz | torch {torch.__version__} cuda {torch.version.cuda}")
    record["device"] = dict(name=card, nvidia_smi=smi_line,
                            sm_clock_max_mhz=clock_mhz,
                            torch=torch.__version__, cuda=torch.version.cuda)

    lap("card")
    # 2. build
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    log(f"built {_build.sources()} in {build_s:.1f} s")
    ptxas = {}
    for src, out in _build.build_log.items():
        ptxas[src] = [line.strip() for line in out.splitlines()
                      if any(k in line for k in ("entry function",
                                                 "registers", "spill"))]
        for line in ptxas[src]:
            log(f"  {src}: {line}")
    record.update(build_s=build_s, ptxas=ptxas)

    lap("2_build")
    # 3. kernel vs plain on the card
    poses = compose_orbit_camposes(
        [2.2] * 8, [15.0, 30.0, 0.0, -15.0] * 2,
        [30.0 + 45.0 * i for i in range(8)])
    scenes = {
        "20k_256": (make_splat(20_000, 0.02, 3, dev),
                    Camera.from_orbit(20.0, 45.0, 2.2, width=256, height=256,
                                      device=dev)),
        # the main path's splat and its first view
        "100k_800": (make_splat(100_000, 0.01, 0, dev),
                     Camera.from_camposes(poses[0], width=800, height=800,
                                          device=dev)),
    }
    compare, inputs, stops_by, plain_img = {}, {}, {}, {}
    fwd_out, scene_of = {}, {}
    for sname, (splat, cam) in scenes.items():
        inputs[sname] = inp = flat_inputs(splat, cam)
        for merged in (True, False):
            label = f"{sname}_{'merged' if merged else 'per_subtile'}"
            compare[label], fwd_out[label], img = kernel_vs_plain(
                label, inp, merged)
            stops_by[label] = fwd_out[label][2]
            scene_of[label] = sname
            if merged:
                plain_img[sname] = img
    # bins of 48 and 64 px: clusters of 9 and 16 sub-tile CTAs
    for bin_px in (48, 64):
        wide = flat_inputs(*scenes["20k_256"], bin_px=bin_px)
        for merged in (True, False):
            label = f"20k_256_bin{bin_px}_" \
                f"{'merged' if merged else 'per_subtile'}"
            compare[label] = kernel_vs_plain(label, wide, merged)[0]
        del wide
    record["kernel_vs_plain"] = compare

    lap("3_flat_kernels")
    # 4. the main path: GS-PLY → load on the card → 8 orbit views at 800²
    asset_dir = os.path.join(_build.BUILD_DIR, "chip_smoke")
    os.makedirs(asset_dir, exist_ok=True)
    ply_path = os.path.join(asset_dir, "splat_100k.ply")
    save_gs_ply(ply_path, scenes["100k_800"][0])
    splat = load_gs_ply(ply_path, device="cuda")
    check(splat.device.type == "cuda", "load_gs_ply did not load on cuda")
    check(torch.equal(splat.xyz, scenes["100k_800"][0].xyz),
          "GS-PLY round trip changed the splat")
    # the graphs' input files beside it (phases 17-19), and their outputs
    workflow_files(asset_dir, asset_dir)
    cams = Camera.from_camposes(poses, width=800, height=800, device="cuda")

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = G.render(splat, cams)
    torch.cuda.synchronize()
    render8_s = time.perf_counter() - t0
    launches = read_launches()
    log(f"main path: 8 views in {render8_s * 1e3:.1f} ms (first call), "
        f"launches {launches}")
    expect_launches(launches, "flat", 8, 0, "8 views")
    img, alpha = out["image"], out["alpha"]
    check(tuple(img.shape) == (8, 800, 800, 3), f"image shape {img.shape}")
    check(bool(torch.isfinite(img).all()) and bool(
        torch.isfinite(alpha).all()) and bool(
        torch.isfinite(out["depth"]).all()), "non-finite output")
    mean_alpha = float(alpha.mean())
    check(0.0 < mean_alpha < 1.0, f"mean alpha {mean_alpha}")
    view0_db = psnr(img[0], plain_img["100k_800"])
    check(view0_db >= TOL_PSNR_DB,
          f"view 0 vs the plain compositor: {view0_db:.2f} dB")
    # splats whose 3σ box spans more than k = 4 bins keep only 4 of them,
    # as in the JAX package; the flag is reported, not an error
    overflow_views = int(out["overflow"].sum())

    # timings (CUDA events), after the counted run
    cam0 = Camera.from_camposes(poses[0], width=800, height=800, device=dev)
    inp = inputs["100k_800"]
    kargs = {m: flat_kernel_args(inp, m == "merged")
             for m in ("merged", "per_subtile")}
    times = {
        "frame_ms": cuda_ms(lambda: G.render(splat, cam0), 20),
        "kernel_merged_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows(*kargs["merged"][0]), 20),
        "kernel_per_subtile_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows(
                *kargs["per_subtile"][0]), 20),
        "plain_merged_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows_plain(
                *kargs["merged"][0]), 5, warmup=1),
        "plain_per_subtile_ms": cuda_ms(
            lambda: gs_flat.composite_bins_fwd_rows_plain(
                *kargs["per_subtile"][0]), 5, warmup=1),
        "sort_ms": cuda_ms(
            lambda: G.binning.bin_coarse(*inp["sort_args"]), 20),
        "old_gather_ms": cuda_ms(lambda: flat_gather(inp), 20),
        "prep_ms": cuda_ms(lambda: flat_inputs(splat, cam0), 20),
        "render_8_views_ms": cuda_ms(lambda: G.render(splat, cams), 5),
    }
    log(f"times at 800²/100k: {times}")
    prof = profile_frames(lambda: G.render(splat, cam0), 5,
                          rows=tuple(inp["rows"].shape))
    prof["device_idle_share"] = 1.0 - prof["device_busy_ms"] / times["frame_ms"]
    log(f"profile of one frame: {prof}")
    check(prof["row_gathers"] == 0, f"the flat frame still gathers pair "
          f"rows: {prof['row_gather_ops']}")
    box = flat_box_stats(inp, stops_by["100k_800_merged"])
    log(f"flat render view 0, per-splat box: {box}")
    check_box(box, "flat render view 0")

    # bounds of the function with its gather, per mode, from this input
    bounds_rec = {
        "merged": flat_fwd_bound(inp, stops_by["100k_800_merged"], box),
        "per_subtile": flat_fwd_bound(inp, stops_by["100k_800_per_subtile"])}
    log(f"bounds: {bounds_rec}")

    def err(label):
        return max(compare[label]["max_abs_err_acc"],
                   compare[label]["max_abs_err_trans"])

    kernel = {
        "name": "gs_flat_fwd", "route": "cuda",
        "source": "comfy3d_tpu_torch/csrc/gs_flat_fwd.cu",
        "replaces": "comfy3d_tpu/ops/pallas/gs_flat.py:339",
        "launches": launches["gs_flat_fwd"],
        "max_abs_err": max(err(k) for k in compare),
        "ms": times["kernel_merged_ms"],
        "kernel_ms": times["kernel_merged_ms"],
        "plain_ms": times["plain_merged_ms"],
        "bound_ms": bounds_rec["merged"]["bound_ms"],
        "bound_by": bounds_rec["merged"]["bound_by"],
        "library_ms": None,
        "modes": {
            "merged": {
                "replaces": "comfy3d_tpu/ops/pallas/gs_flat.py:339",
                "ms": times["kernel_merged_ms"],
                "plain_ms": times["plain_merged_ms"],
                "max_abs_err": max(err(k) for k in compare
                                   if k.endswith("_merged")),
                **bounds_rec["merged"]},
            "per_subtile": {
                "replaces": "comfy3d_tpu/ops/pallas/gs_flat.py:198",
                "ms": times["kernel_per_subtile_ms"],
                "plain_ms": times["plain_per_subtile_ms"],
                "max_abs_err": max(err(k) for k in compare
                                   if k.endswith("_per_subtile")),
                **bounds_rec["per_subtile"]},
        },
    }
    record.update(main_path=dict(views=8, size=800, splats=100_000,
                                 launches=launches, mean_alpha=mean_alpha,
                                 view0_vs_plain_psnr_db=view0_db,
                                 overflow_views=overflow_views,
                                 first_call_8_views_s=render8_s, box=box),
                  times=times, profile=prof)

    lap("4_render_path")
    # 5. the compositor backward vs its plain version, both scenes and modes
    bwd_compare = {label: bwd_vs_plain(label, inputs[scene_of[label]],
                                       fwd_out[label], seed)
                   for seed, label in enumerate(fwd_out)}
    record["bwd_vs_plain"] = bwd_compare
    del fwd_out, stops_by
    torch.cuda.empty_cache()

    lap("5_flat_backward")
    # 6. the trainer learns; 7. the training path at full width
    record["trainer_learns"] = trainer_learns(dev)
    train_rec, train_times, train_prof, bwd_bound_rec = train_full_width(
        dev, asset_dir, clock_mhz=clock_mhz)
    record.update(train_path=train_rec, train_times=train_times,
                  train_profile=train_prof, bwd_bound=bwd_bound_rec)
    torch.cuda.empty_cache()

    lap("6_7_train_path")
    # 8. the tile compositor, forward and backward, vs its plain versions
    tile_cmp, tile_bwd_cmp = {}, {}
    for seed, (sname, m) in enumerate((("20k_256", 512), ("100k_800", 1024))):
        t_inp = tile_inputs(*scenes[sname], m)
        label = f"{sname}_m{m}"
        tile_cmp[label], t_fwd, _ = tile_kernel_vs_plain(label, t_inp)
        tile_bwd_cmp[label] = tile_bwd_vs_plain(label, t_inp, t_fwd, seed)
        del t_inp, t_fwd
    record.update(tile_vs_plain=tile_cmp, tile_bwd_vs_plain=tile_bwd_cmp)
    torch.cuda.empty_cache()

    lap("8_tile_kernels")
    # 9. the tile render path; 10. the tile train path
    tile_rec, tile_times, tile_prof, tile_fwd_bound_rec = tile_render_path(
        dev, splat, cams, cam0, img, scenes["20k_256"])
    record.update(tile_render_path=tile_rec, tile_times=tile_times,
                  tile_profile=tile_prof, tile_fwd_bound=tile_fwd_bound_rec)
    del out, img, alpha
    torch.cuda.empty_cache()
    record["tile_trainer_learns"] = trainer_learns(dev, backend="tile")
    (tile_train_rec, tile_train_times, tile_train_prof,
     tile_bwd_bound_rec) = train_full_width(dev, asset_dir, backend="tile",
                                            clock_mhz=clock_mhz)
    record.update(tile_train_path=tile_train_rec,
                  tile_train_times=tile_train_times,
                  tile_train_profile=tile_train_prof,
                  tile_bwd_bound=tile_bwd_bound_rec)
    del splat, cams
    torch.cuda.empty_cache()

    lap("9_10_tile_paths")
    # 11. TripoSR image → mesh; no compositor kernel may launch
    reset_launches()
    t0 = time.perf_counter()
    record["triposr"] = triposr_path(dev, asset_dir, smi_line)
    record["triposr"]["s"] = time.perf_counter() - t0
    record["triposr"]["launches"] = read_launches()
    check(not any(record["triposr"]["launches"].values()),
          f"the TripoSR path launched a compositor kernel: "
          f"{record['triposr']['launches']}")

    lap("11_triposr")
    # 12. InstantMesh posed views → mesh; 13. the mesh orbit renderer; no
    # compositor kernel may launch on either
    for phase, path, run in (
            (12, "instantmesh",
             lambda: instantmesh_path(dev, asset_dir, smi_line)),
            (13, "mesh_render", lambda: mesh_render_path(dev, im_mesh))):
        reset_launches()
        t0 = time.perf_counter()
        out = run()
        if path == "instantmesh":
            out, im_mesh = out
        record[path] = out
        record[path]["s"] = time.perf_counter() - t0
        record[path]["launches"] = read_launches()
        check(not any(record[path]["launches"].values()),
              f"the {path} path launched a compositor kernel: "
              f"{record[path]['launches']}")
        torch.cuda.empty_cache()
        lap(f"{phase}_{path}")
    del im_mesh

    # 14. MVDream text → four views → LGM → splats → gs_to_mesh's 24-view
    # orbit, where K1′ launches once per view (counted in the phase)
    t0 = time.perf_counter()
    with torch.no_grad():
        mvl, lgm_out = mvdream_lgm_path(dev, asset_dir, smi_line)
    record["mvdream_lgm"] = mvl
    mvl["s"] = time.perf_counter() - t0
    mvl["launches"] = mvl["orbit"]["launches"]
    mvl_view0 = mvl["orbit"]["view0"]
    lap("14_mvdream_lgm")

    # 15. the GS→mesh converter on a structured shell and on phase 14's
    # splats, where K1′ launches once per supervision view (counted in the
    # phase)
    t0 = time.perf_counter()
    g2m = record["gs_to_mesh"] = gs_to_mesh_path(dev, asset_dir, smi_line)
    g2m["s"] = time.perf_counter() - t0
    g2m_view0 = g2m["shell"]["view0"]
    torch.cuda.empty_cache()
    lap("15_gs_to_mesh")

    # 16. Zero123Plus image → grid → six views → InstantMesh → mesh, where
    # no compositor kernel may launch (counted in the phase)
    t0 = time.perf_counter()
    with torch.no_grad():
        z123 = record["zero123plus_instantmesh"] = \
            zero123plus_instantmesh_path(dev, asset_dir, smi_line)
    z123["s"] = time.perf_counter() - t0
    z123["launches"] = z123["mesh"]["launches"]
    lap("16_zero123plus_instantmesh")

    # 17. Hunyuan3D-2.1 shape image → latents → octree grid → mesh, where
    # no compositor kernel may launch (counted in the phase)
    t0 = time.perf_counter()
    with torch.no_grad():
        hy3d, hy3d_sphere = hunyuan3d_shape_path(dev, asset_dir, smi_line)
    record["hunyuan3d_shape"] = hy3d
    hy3d["s"] = time.perf_counter() - t0
    hy3d["launches"] = hy3d["image_to_mesh"]["launches"]
    lap("17_hunyuan3d_shape")

    # 18. Hunyuan3D-2.1 paint of phase 17's sphere → PBR textures, where no
    # compositor kernel may launch (counted in the phase)
    t0 = time.perf_counter()
    with torch.no_grad():
        paint = record["hunyuan3d_paint"] = hunyuan3d_paint_path(
            dev, asset_dir, smi_line, hy3d_sphere)
    paint["s"] = time.perf_counter() - t0
    paint["launches"] = paint["b"]["launches"]
    del hy3d_sphere
    lap("18_hunyuan3d_paint")

    # 19. configs 1-4 and the 3DGS fit as graphs through run_workflow (19a-d,
    # 19f); config 5's two graphs (19e) ran as phases 17b and 18b
    t0 = time.perf_counter()
    wf = workflows_path(dev, asset_dir, lgm_out)
    wf["config5_shape"] = hy3d["image_to_mesh"]["graph"]
    wf["config5_texgen"] = paint["b"]["graph"]
    record["workflows"] = wf
    del lgm_out
    wf_dir = os.path.join(HERE, "chiprun_out", WF_DIR)
    os.makedirs(wf_dir, exist_ok=True)
    for name in sorted(os.listdir(os.path.join(asset_dir, WF_DIR))):
        if name.endswith(".png"):
            shutil.copy(os.path.join(asset_dir, WF_DIR, name), wf_dir)
    with open(os.path.join(wf_dir, "workflows.json"), "w") as f:
        json.dump(wf, f, indent=1)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")
    fit_view0, fit_bwd = wf["3dgs_fit"]["view0"], wf["3dgs_fit"]["view0_bwd"]
    lap("19_workflows")

    # 20. CRM image → six views → six CCMs → mesh and the CRM graphs, where
    # no compositor kernel may launch, then ImageDream → LGM → the
    # converter's orbit, where K1′ launches once per view (counted in the
    # phase)
    t0 = time.perf_counter()
    with torch.no_grad():
        crm = record["crm"] = crm_path(dev, asset_dir, smi_line)
    crm["s"] = time.perf_counter() - t0
    id_orbit = crm["imagedream_lgm"]["orbit"]
    id_view0 = id_orbit["view0"]
    lap("20_crm_imagedream")

    # 21. Wonder3D and Era3D image → six views + normal maps and the
    # multi-view mesh fit, where no compositor kernel may launch (counted
    # in the phase)
    t0 = time.perf_counter()
    mvd = record["mvdiffusion_fit"] = mvdiffusion_fit_path(dev, asset_dir,
                                                           smi_line)
    mvd["s"] = time.perf_counter() - t0
    for part in ("era3d", "wonder3d"):
        check(not any(mvd[part]["launches"].values()),
              f"the {part} path launched a compositor kernel: "
              f"{mvd[part]['launches']}")
    lap("21_mvdiffusion_fit")

    # 22. FlexiCubes multi-view depth → mesh, where the soft-silhouette
    # kernels launch once per view of each fit step, forward and backward
    # (counted in the phase)
    t0 = time.perf_counter()
    fc = record["flexicubes"] = flexicubes_path(dev, asset_dir, smi_line)
    fc["s"] = time.perf_counter() - t0
    lap("22_flexicubes")

    # 23. TripoSG image / scribble → mesh, where no kernel may launch
    # (counted in the phase)
    t0 = time.perf_counter()
    with torch.no_grad():
        tsg = record["triposg"] = triposg_path(dev, asset_dir, smi_line)
    tsg["s"] = time.perf_counter() - t0
    lap("23_triposg")

    def by_path(name):
        return {"render_8_views": launches[name],
                "train_10_steps": train_rec["launches"][name],
                "tile_render_8_views": tile_rec["launches"][name],
                "tile_train_10_steps": tile_train_rec["launches"][name],
                "triposr": record["triposr"]["launches"][name],
                "instantmesh": record["instantmesh"]["launches"][name],
                "mesh_render": record["mesh_render"]["launches"][name],
                "mvdream_lgm_orbit_24": mvl["launches"][name],
                "gs_to_mesh": g2m["shell"]["launches"][name],
                "zero123plus_instantmesh": z123["launches"][name],
                "hunyuan3d_shape": hy3d["launches"][name],
                "hunyuan3d_paint": paint["launches"][name],
                **{f"workflow_{k}": v["launches"][name]
                   for k, v in wf.items()},
                "crm": crm["launches"][name],
                **{f"workflow_{k}": v["launches"][name]
                   for k, v in crm["graphs"].items()},
                "imagedream_lgm_orbit_24": id_orbit["launches"][name],
                "era3d": mvd["era3d"]["launches"][name],
                "wonder3d": mvd["wonder3d"]["launches"][name],
                "workflow_era3d_fit": mvd["graph"]["launches"][name],
                "workflow_flexicubes": fc["b"]["launches"][name],
                "flexicubes_tets_step": fc["c"]["launches"][name],
                "workflow_triposg": tsg["c"]["graph"]["launches"][name],
                "workflow_triposg_scribble":
                    tsg["d"]["graph"]["launches"][name]}

    kernel["launches_by_path"] = by_path("gs_flat_fwd")
    kernel["design"] = ("one CTA per sub-tile, a cluster per bin, rows "
                        "read by index (cp.async ring), box skip")
    kernel["by_path"] = {
        "render_view0": dict(ms=times["kernel_merged_ms"],
                             bound_ms=bounds_rec["merged"]["bound_ms"],
                             launches=launches["gs_flat_fwd"]),
        "train_view0_trained": dict(
            ms=train_times["kernel_fwd_ms"],
            bound_ms=train_rec["fwd_bound"]["bound_ms"],
            launches=train_rec["launches"]["gs_flat_fwd"]),
        "mvdream_lgm_view0": dict(
            ms=mvl_view0["kernel_ms"], plain_ms=mvl_view0["plain_ms"],
            bound_ms=mvl_view0["bound"]["bound_ms"],
            bound_by=mvl_view0["bound"]["bound_by"],
            max_abs_err=max(mvl_view0["max_abs_err_acc"],
                            mvl_view0["max_abs_err_trans"]),
            launches=mvl["launches"]["gs_flat_fwd"]),
        "gs_to_mesh_view0": dict(
            ms=g2m_view0["kernel_ms"], plain_ms=g2m_view0["plain_ms"],
            bound_ms=g2m_view0["bound"]["bound_ms"],
            bound_by=g2m_view0["bound"]["bound_by"],
            max_abs_err=max(g2m_view0["max_abs_err_acc"],
                            g2m_view0["max_abs_err_trans"]),
            launches=g2m["shell"]["launches"]["gs_flat_fwd"]),
        "3dgs_fit_view0": dict(
            ms=fit_view0["kernel_ms"], plain_ms=fit_view0["plain_ms"],
            bound_ms=fit_view0["bound"]["bound_ms"],
            bound_by=fit_view0["bound"]["bound_by"],
            max_abs_err=max(fit_view0["max_abs_err_acc"],
                            fit_view0["max_abs_err_trans"]),
            launches=wf["3dgs_fit"]["launches"]["gs_flat_fwd"]),
        "imagedream_lgm_view0": dict(
            ms=id_view0["kernel_ms"], plain_ms=id_view0["plain_ms"],
            bound_ms=id_view0["bound"]["bound_ms"],
            bound_by=id_view0["bound"]["bound_by"],
            max_abs_err=max(id_view0["max_abs_err_acc"],
                            id_view0["max_abs_err_trans"]),
            launches=id_orbit["launches"]["gs_flat_fwd"])}
    kernel["max_abs_err"] = max(
        kernel["max_abs_err"],
        *(kernel["by_path"][k]["max_abs_err"]
          for k in ("mvdream_lgm_view0", "gs_to_mesh_view0",
                    "3dgs_fit_view0", "imagedream_lgm_view0")))
    kernel_bwd = {
        "name": "gs_flat_bwd", "route": "cuda",
        "source": "comfy3d_tpu_torch/csrc/gs_flat_bwd.cu",
        "replaces": "comfy3d_tpu/ops/pallas/gs_flat.py:552",
        "launches": train_rec["launches"]["gs_flat_bwd"],
        "launches_by_path": by_path("gs_flat_bwd"),
        "max_abs_err": max(r["max_abs_err"] for r in
                           (*bwd_compare.values(), fit_bwd)),
        "max_rel_err": max(r["max_rel_err"] for r in
                           (*bwd_compare.values(), fit_bwd)),
        "ms": train_times["kernel_bwd_ms"],
        "kernel_ms": train_times["kernel_bwd_ms"],
        "plain_ms": train_times["plain_bwd_ms"],
        "bound_ms": bwd_bound_rec["bound_ms"],
        "bound_by": bwd_bound_rec["bound_by"],
        "library_ms": None,
        "computes": "backward + per-splat scatter",
        "old_scatter_ms": train_times["old_scatter_ms"],
        "old_design": train_rec["old_design"],
        "by_path": {
            "train_view0_trained": dict(
                ms=train_times["kernel_bwd_ms"],
                plain_ms=train_times["plain_bwd_ms"],
                bound_ms=bwd_bound_rec["bound_ms"],
                bound_by=bwd_bound_rec["bound_by"],
                launches=train_rec["launches"]["gs_flat_bwd"]),
            "3dgs_fit_view0": dict(
                ms=fit_bwd["kernel_ms"], plain_ms=fit_bwd["plain_ms"],
                bound_ms=fit_bwd["bound"]["bound_ms"],
                bound_by=fit_bwd["bound"]["bound_by"],
                max_abs_err=fit_bwd["max_abs_err"],
                max_rel_err=fit_bwd["max_rel_err"],
                launches=wf["3dgs_fit"]["launches"]["gs_flat_bwd"])},
    }
    kernel_tile_fwd = {
        "name": "gs_tile_fwd", "route": "cuda",
        "source": "comfy3d_tpu_torch/csrc/gs_tile_fwd.cu",
        "replaces": "comfy3d_tpu/ops/pallas/gs_tile.py:92",
        "launches": tile_rec["launches"]["gs_tile_fwd"],
        "launches_by_path": by_path("gs_tile_fwd"),
        "max_abs_err": max(max(r["max_abs_err_acc"], r["max_abs_err_trans"])
                           for r in tile_cmp.values()),
        "ms": tile_times["kernel_fwd_ms"],
        "kernel_ms": tile_times["kernel_fwd_ms"],
        "plain_ms": tile_times["plain_fwd_ms"],
        "bound_ms": tile_fwd_bound_rec["bound_ms"],
        "bound_by": tile_fwd_bound_rec["bound_by"],
        "library_ms": None,
        "design": "rows read by index (cp.async ring), box skip, writes "
                  "the backward's block when asked",
        "by_path": {
            "render_view0_m1024": dict(
                ms=tile_times["kernel_fwd_ms"],
                bound_ms=tile_fwd_bound_rec["bound_ms"],
                launches=tile_rec["launches"]["gs_tile_fwd"]),
            "train_view0_trained_m512": dict(
                ms=tile_train_times["kernel_fwd_ms"],
                bound_ms=tile_train_rec["fwd_bound"]["bound_ms"],
                launches=tile_train_rec["launches"]["gs_tile_fwd"],
                block_kept=True)},
    }
    kernel_tile_bwd = {
        "name": "gs_tile_bwd", "route": "cuda",
        "source": "comfy3d_tpu_torch/csrc/gs_tile_bwd.cu",
        "replaces": "comfy3d_tpu/ops/pallas/gs_tile.py:127",
        "launches": tile_train_rec["launches"]["gs_tile_bwd"],
        "launches_by_path": by_path("gs_tile_bwd"),
        "max_abs_err": max(r["max_abs_err"] for r in tile_bwd_cmp.values()),
        "max_rel_err": max(r["max_rel_err"] for r in tile_bwd_cmp.values()),
        "ms": tile_train_times["kernel_bwd_ms"],
        "kernel_ms": tile_train_times["kernel_bwd_ms"],
        "plain_ms": tile_train_times["plain_bwd_ms"],
        "bound_ms": tile_bwd_bound_rec["bound_ms"],
        "bound_by": tile_bwd_bound_rec["bound_by"],
        "library_ms": None,
        "computes": "backward + per-splat scatter",
        "old_scatter_ms": tile_train_times["old_scatter_ms"],
        "old_design": tile_train_rec["old_design"],
    }
    sil = []
    for part in ("fwd", "bwd"):
        a, b = fc["a"], fc["b"]["main_shape"]
        bound = b[f"{part}_bound"]
        err = "max_abs_err" if part == "fwd" else "grad_max_abs_err"
        sil.append({
            "name": f"soft_silhouette_{part}", "route": "cuda",
            "source": "comfy3d_tpu_torch/csrc/soft_silhouette.cu",
            "replaces": "comfy3d_tpu/ops/rasterize.py:442",
            "replaces_note": "an XLA scan, no Pallas kernel",
            "launches": fc["b"]["launches"][f"soft_silhouette_{part}"],
            "launches_by_path": by_path(f"soft_silhouette_{part}"),
            "max_abs_err": max(a[err], b[err]),
            "ms": b[f"{part}_ms"], "plain_ms": b[f"plain_{part}_ms"],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None,
            "computes": ("per-pixel log-sum of the clipped coverages"
                         if part == "fwd" else "its gradient to the "
                         "faces' screen corners"),
            "by_path": {
                "22a_res64_256": dict(
                    ms=a[f"{part}_ms"], plain_ms=a[f"plain_{part}_ms"],
                    max_abs_err=a[err], **a[f"{part}_bound"]),
                "22b_res128_512": dict(
                    ms=b[f"{part}_ms"], plain_ms=b[f"plain_{part}_ms"],
                    max_abs_err=b[err], **bound,
                    launches=fc["b"]["launches"][
                        f"soft_silhouette_{part}"])}})
    record["phase_s"] = phase_s
    record["kernels"] = [kernel, kernel_bwd, kernel_tile_fwd, kernel_tile_bwd,
                         *sil]
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)

    print(json.dumps({"main_path": record["main_path"], "times": times,
                      "profile": {k: v for k, v in prof.items()
                                  if k != "top"},
                      "train_path": train_rec, "train_times": train_times,
                      "train_profile": {k: v for k, v in train_prof.items()
                                        if k != "top"},
                      "trainer_learns": record["trainer_learns"],
                      "tile_render_path": tile_rec, "tile_times": tile_times,
                      "tile_profile": {k: v for k, v in tile_prof.items()
                                       if k != "top"},
                      "tile_train_path": tile_train_rec,
                      "tile_train_times": tile_train_times,
                      "tile_train_profile": {
                          k: v for k, v in tile_train_prof.items()
                          if k != "top"},
                      "tile_trainer_learns": record["tile_trainer_learns"]}))
    print(json.dumps({"phase_s": phase_s}))
    print(json.dumps({"triposr": record["triposr"]}))
    print(json.dumps({"instantmesh": record["instantmesh"]}))
    print(json.dumps({"mesh_render": record["mesh_render"]}))
    print(json.dumps({"mvdream_lgm": mvl}))
    print(json.dumps({"gs_to_mesh": g2m}))
    print(json.dumps({"zero123plus_instantmesh": z123}))
    print(json.dumps({"hunyuan3d_shape": hy3d}))
    print(json.dumps({"hunyuan3d_paint": paint}))
    print(json.dumps({"workflows": {
        k: {key: v[key] for key in ("s", "peak_bytes", "launches", "nodes")}
        for k, v in wf.items()}}))
    print(json.dumps({"crm": crm}))
    print(json.dumps({"mvdiffusion_fit": mvd}))
    print(json.dumps({"flexicubes": fc}))
    print(json.dumps({"triposg": tsg}))
    print(json.dumps({"kernels": record["kernels"]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full record (JSON) here")
    sys.exit(main(ap.parse_args().out))
