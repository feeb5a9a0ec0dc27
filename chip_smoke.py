#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (gdpt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card and its power limit; build the native sources of
     gdpt_tpu_torch/csrc (six CUDA files, one C++ file; one compiler
     process each, started together; timed); read every timed kernel's
     registers and local memory from the built libraries;
  2. hold K1 (closest hit) and K2 (any hit) against their plain PyTorch
     versions at the 512x512 cbox's ray count, bit for bit (0 rays may
     differ in the bits of t, u, v, the normal or blocked, or in prim):
     camera rays, random bounce rays from the camera hits and shadow rays
     toward the light, all live and with dead lanes (tfar = -1) scattered
     and in whole warps; then walk one sample of the same box through
     integrators/path_fused.py's schedule and hold each stage kernel (P1
     primary, P2 after_hit, P3 after_shadow) against its plain stage on
     a copy of the same (31, 262,144) lane state, bit for bit;
  3. the brute-force main path: render.render(cornell_box(512, 512,
     spp=4)) on cuda, with the kernel launch counters (K1, K2 and the
     stage kernels) zeroed just before and read just after; the image
     must be finite and not black, and every kernel must have been
     launched;
  4. render cornell_box(32, 32, spp=2, max_depth=3) on cuda and on the
     CPU (plain versions) and hold the two images together;
  5. time K1 and K2 and their plain versions with CUDA events over CUDA
     graph replays (no host launch overhead between calls), beside their
     bound (the larger of bytes over 3.35 TB/s and operations over 67
     TFLOP/s f32, the H100 SXM's published peaks); and P1-P3 and their
     plain stages a launch from each state of phase 2's sample
     (profiling.event_span_ms), averaged over the stage's launches in
     the sample, beside their bytes bound (tools/profile_render.py's
     FUSED_BYTES over 3.35 TB/s);
  6. profile one 512x512 cbox sample: device time by kernel, the device's
     busy share, and the kernels' share of device time;
  7. build the BVH scene: the Cornell box's walls, light and camera with
     the two boxes replaced by subdivided icospheres (levels 7 and 6,
     409,612 triangles): host BVH, packet table (timed);
  8. hold K3 (the BVH walk, closest hit and any hit) against its plain
     version on 262,144 camera, bounce and shadow rays of that scene, on
     a small 16-wide table and on a table with in-table spheres (0 rays
     may differ in t, prim or visit counts), and
     against brute force over every triangle on a 16,384-ray sample
     (grazing rays the walk's box test drops are counted and printed);
  9. the BVH main path: render.render(scene, spp=4) on cuda (packet
     table, kept from phase 7 -> K3 -> wavefront renderer), counters
     zeroed just before and read just after; image finite and not black, both K3 modes launched;
 10. render a small BVH scene (a level-3 icosphere in the box, 32x32,
     2 spp) on cuda and on the CPU and hold the two images together;
 11. time K3 (closest and any hit, rays morton-sorted and unsorted) by
     CUDA graph replay, beside its plain version and its bound, whose
     operations and table rows the plain version counts from these rays'
     own visits;
 12. profile one wavefront chunk (8 iterations) of the BVH render;
 13. build that scene's 16-wide packet table; hold K4 (the dual walk)
     against its plain version and against K3 on it: camera, bounce and
     shadow rays, 262,144 and 262,143 rays, closest and any hit;
 14. hold K5 (the visit microbenchmark) against its plain version in every
     mode on 65,536 rays with 256 visits, bit for bit; then run the tool's
     entry point at 262,144 rays with 2,048 visits on the 32- and the
     16-wide table (counters zeroed just before, read just after, one per
     mode): ns per visit per ray and mode, beside K3's time per visit in
     the walk; and hold K5's super32 and leaf24 at that size against the
     plain version, whose time is taken there, bit for bit;
 15. the gradient-domain main path: render.render of the scene with
     integrator "gradpath", 4 spp, default table (5-path lockstep in the
     wavefront lane pool -> K3 -> screened-Poisson solve), counters zeroed
     just before and read just after; the Poisson solve timed alone;
 16. the same render at 1 spp on the 16-wide table, solo (K3) then dual
     (K4): identical images, K4 launched, K3 not launched by the dual
     render;
 17. render gradpath 32x32 on cuda and on the CPU, brute force (cbox) and
     BVH, and hold reconstruction and gradients together;
 18. time K4 beside K3 on the 16-wide table (rays sorted and unsorted) by
     CUDA graph replay, beside the plain version and the bound;
 19. hold K3 and K4 against their plain versions on the ray batches the
     gradpath lane pool hands the walk in its steady state (the pool's
     own rays, the 8n-lane probe/replay cast with most lanes dead, the
     5n-lane primary cast of a refill, the shadow rays): 0 rays may
     differ; time K3 on the 32- and the 16-wide table and K4 on each by
     CUDA graph replay beside its bound, and sum each walk's time over a
     gradpath iteration; then profile one gradpath wavefront chunk (6
     iterations);
 20. record the K1 and K2 batches of one 512x512 cbox `path` sample and
     one 512x512 cbox `gradpath` sample as the banded loops hand them to
     the wrappers; hold each against its plain version bit for bit, time
     it by CUDA graph replay beside its bound, print its live share, and
     sum K1 + K2 per sample of each render;
 21. the material box (scene/presets.material_box: every material kind,
     a 1024x1024 image on the back wall, a 1024x1024 roughness map on the
     floor, a 512x1024 image envmap; depth cut to 8) at 512x512, 4 spp,
     brute force: `path` and `gradpath` on cuda through K1 and K2 (counts
     zeroed just before each render, read just after); finite images, and
     gradpath's reconstruction keeps its primal's mean;
 22. the 32x32 material box, `path` and `gradpath`, brute force and BVH
     (two small icosphere balls), on cuda and on the CPU, held together;
 23. the BVH material box (the icosphere balls of phase 7 added, the
     large one a Disney BSDF and the small one a rough dielectric; the
     spheres in the packet table) at 512x512: `path` and `gradpath` at 4
     spp through K3 on the 32-wide table, `gradpath` at 1 spp on the
     16-wide table solo (K3) and dual (K4), whose images must be equal;
     K3 held against its plain version, and timed, on a batch of bounce
     rays that start inside the refracting balls (recorded from the
     render's own casts), and K1 on such a batch of the brute-force box;
     4 `path` and 2 `gradpath` wavefront iterations under the profiler:
     launches per iteration, the device's busy share, K3's share;
 24. the brute-force volumetric main path, the stand-in for bench.py's
     volpath_test6: render.render(volpath_scene(version=6, 512, 512,
     spp=8, hetero, diffuse sphere, HG g = 0.6)) with a seeded, varying,
     chromatic 64^3 density grid (max several times its mean, so delta
     tracking takes null collisions) and a 64^3 albedo grid, unbounded
     depth, through the banded loop and K1; counts zeroed just before and
     read just after: K1 launched, K2 not; image finite and not black;
     wall, rays, Mrays/s, K1 launches and host reads of loop conditions
     per sample; one main-cast batch and one shadow batch (rays from
     scatter points) recorded;
 25. volpath 32x32 on cuda and on the CPU: the brute-force grid scene, its
     force_bvh twin (three spheres, no triangle: an empty packet table)
     and a null-boundary scene (the grid medium inside a sphere of
     material -1, the camera outside); images at the gate, ray counts
     equal;
 26. the BVH medium box (scene/presets.medium_box: the icosphere box's
     balls, walls and light, 409,624 triangles, its room filled by a heterogeneous 64^3 medium
     inside a 12-triangle box of material -1, the camera outside in
     vacuum) at 512x512 through the wavefront pool and K3 on the 32-wide
     table; counts zeroed just before and read just after; a main-cast
     batch and two shadow batches (from scatter points; from boundary
     crossings) recorded; K3 held against its plain version on them bit
     for bit in t, prim and visit counts, and phase 24's K1 batches
     likewise; each timed by CUDA graph replay beside its bound;
     iterations and mean occupancy;
 27. two wavefront iterations of phase 26's render under the profiler:
     launches per iteration, the device's busy share, K3's share;
 28. the command-line entry point on a scene file: the 512x512 cbox
     written as XML and binary PLY meshes (scene/xml_writer.py) into a
     temporary directory; `python -m gdpt_tpu_torch <xml> -o <exr> --spp
     4` as a subprocess (exit 0; the EXR read back with the port's
     read_exr: finite, not black), then cli.main on the same file in
     this process with the K1/K2 counts zeroed just before and read just
     after (both launched); the parse time, render wall and EXR write time
     as the command prints them;
 29. the icosphere box (409,612 triangles) written as binary PLY with an
     XML around it, parsed (timed: PLY, BVH) and rendered `gradpath` at 4
     spp through cli.main, K3 counts zeroed and read; the reconstruction
     keeps the primal's mean, as phase 15 checks;
 30. the five AOV kinds at 512x512 on the cbox file (one K1 launch each)
     and on the phase 29 scene (one K3 closest launch each), walls
     printed; mipmap_level on presets.material_box, non-zero somewhere;
     every kind at 32x32 on cuda against the CPU, brute force and BVH, at
     phase 4's gate; the cbox_depth golden (64x64 depth) on cuda within
     its test's bound (RMSE / mean < 0.05);
 31. checkpoint and resume on the card: `path` on the phase 29 scene
     (banded, a sample a pass), `gradpath` on the cbox file and `volpath`
     on a brute-force XML with phase 24's 64^3 grids written as .vol
     files: half the samples rendered with an on_chunk that saves under
     the full render's fingerprint, resumed by render_with_checkpoints,
     held against the uninterrupted render of the same route (bit for
     bit where both sum the same passes, else at the gate, the largest
     difference printed); a 32x32 checkpoint written on cuda resumes on
     the CPU (equal fingerprints);
 32. the per-ray volpath rungs (integrators/volpath.py through
     render.render_samples): volpath_scene versions 1-5 at 512x512, 4 spp
     in one pass of 1,048,576 lanes, unbounded depth (v5 with the diffuse
     sphere), brute force; counts and host reads zeroed just before each
     render and read just after: K1 launched by every rung, K2 by v2
     alone; wall, rays, Mrays/s, K1/K2 launches and host reads of each
     loop per sample; v2's shadow batch (K2) and a v5 bounce cast and
     shadow segment (K1) recorded;
 33. each rung at 32x32 on cuda and on the CPU, and the medium box cut
     to two level-1 balls as v5 and v2 (BVH: K3 closest, and any hit for
     v2): images at phase 4's gate, ray counts equal;
 34. K2 and K1 held bit for bit against their plain versions on phase
     32's batches, and K3 closest on a v5 bounce cast and shadow segment
     of the full-size medium box (1 spp, depth 4, 32-wide table) and K3
     any hit on its v2 shadow rays; each timed by CUDA graph replay
     beside its bound; two v5 bounce iterations of phase 32's render
     under the profiler: launches per iteration, the device's busy
     share, the RNG's share of launches (its draws in the window times
     the launches of one draw, counted alone);
 35. the volpath_v5 golden on cuda (32x32, 32 spp, depth 5, seed 42;
     RMSE / mean < 0.05); a 512x512 v5 scene file (8 spp in two passes,
     depth 4) rendered by `python -m gdpt_tpu_torch` as a subprocess,
     then its first pass checkpointed in process (the render stopped
     after it) and resumed by render_with_checkpoints: equal bit for bit
     to the command's image;
 36. the per-ray `path` oracle (integrators/path.py through
     render.render_samples) at 512x512, 4 spp in one pass of 1,048,576
     lanes: the cbox (K1, K2) and phase 7's icosphere box (K3 closest and
     any hit on the 32-wide table); counts and host reads zeroed just
     before each render and read just after, exactly the route's kernels
     launched; wall, rays, Mrays/s, launches and host reads per sample;
     the mean held to the SoA `path` image's within 6%
     (tests/test_soa.py's gate); a bounce cast and a shadow batch kept;
 37. the per-ray gradient-domain render, gdpt.render_gradpath (one
     sample a pass: 262,144 base and 1,048,576 offset lanes), depth 5:
     the cbox at 4 spp (K1, K2) and the icosphere box at 2 spp (K3); the
     same numbers and the peak device memory; the reconstruction keeps
     its primal's mean within 2%; the offsets' reconnection-probe and
     replay batches kept;
 38. the per-ray final volpath version (volpath.trace_volpath_final
     through render_samples): phase 24's grid scene at 4 spp, depth 6
     (K1), and the medium box at 1 spp, depth 4 (K3); host reads of each
     loop (bounce, flight, segment, ratio tracking) per sample; the mean
     held to volpath_soa's on the same scene within 6%; a bounce cast and
     a shadow segment kept;
 39. each of the three at 32x32 on cuda and on the CPU at phase 4's gate
     with equal ray counts (every gradpath buffer); the cbox_gdpt golden
     through render_gradpath on cuda (RMSE / mean < 0.05); K1, K2 and K3
     held bit for bit against their plain versions on the batches kept in
     phases 36-38 (among them the gradpath probe and a final-version
     shadow segment), each timed by CUDA graph replay beside its bound;
 40. the two-phase entry traversal (packet_trace.trace_two_phase) on
     phase 7's 32- and 16-wide tables: 1,048,576 camera rays (512x512x4)
     and phase 8's 262,144 bounce rays closest, its shadow rays any hit,
     through K3 on both tables and K4 on the 16-wide one (counts zeroed
     just before each cast and read just after): t and the any-hit mask
     equal to the single-phase cast's, a differing prim only on a tie;
     on a cut of 65,536 rays of each set the kernel under the two-phase
     walk equals the plain walk under it bit for bit; each cast's wall
     (CUDA events) beside the single-phase one, its dispatches, kernel
     launches and the share of live lanes that reach the root walk; then
     render.render of the icosphere box's gradpath at 2 spp with
     two_phase=True against False: images at the gate, rays within 0.1%;
 41. the pool-sorted wavefronts (pool_sort=True against False): the
     icosphere box's path (4 spp) and gradpath (2 spp) and the medium
     box's volpath (1 spp): images at the gate, equal ray counts, K3
     launched, walls both ways; the path also with packet_sort=False
     (no cast sorts, no morton key computed) against the default; then
     the sort kernels' device time per iteration of the path and
     gradpath wavefronts under the profiler, every cast sorting against
     the pool sorted once per chunk;
 42. sharding (parallel/sharding.py): make_mesh() on the card and a mesh
     of cuda:0 four times; render_soa_sharded on the cbox (4 spp, K1,
     K2), render_gradpath_soa_sharded on the icosphere box (2 spp, depth
     5, banded, K3), render_volpath_soa_sharded on the grid scene (2 spp,
     depth 6, K1) and render_samples_sharded with path.trace_path on the
     cbox (4 spp), each equal to its unsharded banded render bit for bit
     with its ray count (no lane padded at 512x512); a 30x30 sharded
     render (124 padded lanes) on cuda against the CPU at the gate;
 43. the reference's XLA walks in plain PyTorch on phase 7's tables and
     phase 8's rays (262,144 bounce rays closest, 262,144 shadow rays any
     hit, 65,536 camera rays closest): the packed walk over bvh_nodes48,
     the per-lane walk over the BVH arrays, the super16 walk (its table
     built from the same BVH; L and rows printed) and the per-ray
     traverse.intersect_bvh / occluded_bvh, each held against K3 on the
     32-wide table, the packed and super16 walks also against K4 on the
     16-wide one: t of a hit equal to the kernel's (within an ulp), the
     hit and any-hit masks equal but for rays that graze a box (counted
     and printed, held to phase 8's bounds), prim equal but on a tie;
     each walk's wall (CUDA events), steps (mean, max), host reads and
     peak device memory; then traverse.intersect_brute / occluded_brute
     against K1 / K2 on phase 2's cbox rays (t and the masks equal);
 44. render.render of the icosphere box's `path` at 512x512, 1 spp,
     with packet=False (the packed walk) and with max_table_mb=0 (the
     super16 walk), counts zeroed just before each render and read just
     after (no packet kernel launched, the walk's host reads counted):
     each image at the gate against the default render, rays within
     0.1%, walls and rays printed;
 45. the measurement entry points: the FMA-peak kernel
     (csrc/fma_peak.cu) held against its plain version (CPU) at rtol
     1e-5 on 4,096 values and on 4,096 values of its timed 2^22-value
     block, its f32 rate printed beside the published 67 TFLOP/s (over
     105% of it fails); tools/speed_of_light.measure_kernels for the cbox
     and the icosphere box at 2^20 rays (FMA peak, K1, K2, K3 counted),
     each chained cast (8 casts in a CUDA graph) held to one eager cast;
     the icosphere box's visit floor (K3's counts, K5's prices); the
     bench's bench_config for cbox_512_path at 4 spp (its cut in
     detail.reduced, its rays those of one render.render of the same
     scene, K1 and K2 counted) and for icosphere_box_gradpath on phase
     7's scene (its rays phase 15's, K3 counted); examples/small_gdpt at
     64x48, 2 spp; entry() and dryrun_multichip(4) on cuda:0;
 46. the stage profilers and cast A/B tools of gdpt_tpu_torch/tools, each
     stage row with its wall, its device operations and device time from
     one torch.profiler run, and K1-K4's launches and share: profile_render
     (a banded sample replayed stage by stage, 8 bounces, then 2^20-ray
     probes) on the 512x512 BVH material box (tools/stand_ins.py
     material_box_bvh) and on the cbox: bounce 1's live lanes equal the
     primary hits, every stage launches;
 47. profile_wavefront (the wavefront body stage by stage on a pool of
     262,144 lanes after 24 iterations) and profile_nee on the material
     box: the stages' summed device time within the body's wall;
 48. trace_decompose on the icosphere box's captured pool rays: sort, the
     sorted cast, the pre-sorted cast, K3 alone (closest, any hit), the
     unsort and the hit attributes; the pre-sorted cast, unsorted, equal to
     the sorted cast bit for bit;
 49. ab_dual_kernel (K4 against K3 on the 16-wide table: equal hits
     first), ab_wide_kernel (32- against 16-wide: equal masks, prims but
     on ties), chain_sweep (1-16 chained casts, eager and one CUDA graph,
     time = C + K x cast fitted; K3 and K4) on the icosphere box's pool,
     bounce and shadow rays, and occl_ab on the icosphere box (K3 any hit)
     and the cbox (K2): compacted shadow casts equal full-width ones on
     every live ray;
 50. occupancy_report (banded against wavefront) for the icosphere box's
     path (2 spp) and gradpath (1 spp) and the grid scene's volpath (1
     spp): each row's rays equal, and its mean within 1e-5, to those of a
     render.render of the same scene, integrator and loop.

Prints one "kernels" JSON line (the FMA-peak kernel's row last; every
row also carries its kernel's
registers and local bytes, K1's and K2's phase 20's time per sample of
each render, K1's and K3 closest's launches per volpath sample of phases
24 and 26, under "rungs" K1's, K2's and K3's launches per sample of
the rungs (phases 32, 34) and the time and bound of each rung batch of
phase 34, and under "perray" their launches per sample of each per-ray
oracle (phases 36-38) and the time and bound of each batch of phase 39,
and K3's and K4's rows under "two_phase" each phase 40 cast's wall
(wall_ms, not the kernel's own time), the single-phase wall, kernel
launches a cast and root-walk share, and K1's to K4's rows under
"oracles" each phase 43 walk held against that kernel: its wall_ms
(the plain PyTorch walk's, not a kernel time), steps, host reads, peak
memory and the rays that differ; K3's rows under "decompose" phase 48's
stages (wall, device time, launches), K3's and K4's closest-hit rows
under "chain" phase 49's fits of eager and graph chains),
then the card's name and power limit, and
last {"ok": true, "device": {...}}. Exits non-zero, printing no result,
without a CUDA device or without the gdpt_tpu_torch package beside it.
"""

import contextlib
import json
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
OPS_PER_TRI_PAIR = 52       # 46 f32 add/sub/mul/div + 6 compares
OPS_PER_SPH_PAIR = 40       # 34 f32 add/sub/mul/div/max/sqrt + 6 compares
OPS_PER_BOX = 25            # slab test: 6 mul, 6 sub, 12 min/max, 1 compare
SPP_MAIN = 4                # brute-force main path
SPP_BVH = 4                 # BVH main path
SPP_GRAD = 4                # gradient-domain main path
N_BRUTE_SAMPLE = 16384      # rays held against brute force over all triangles
MAT_SPP = 4                 # material box renders
MAT_DEPTH = 8               # the material box's path depth, cut from unbounded
MAT_IMAGES = dict(image_px=1024, env_px=512)   # 1024x1024 wall and floor maps, 512x1024 envmap
# The 32x32 box of phase 22: small images, depth 3, two small balls for BVH.
MAT_SMALL = dict(image_px=64, env_px=32, max_depth=3)
MAT_SMALL_BALLS = [(3, (368.0, 100.0, 351.0), 100.0), (2, (186.0, 60.0, 169.0), 60.0)]
VOL_SPP = 8                 # brute-force volpath main path, cut from volpath_test6's 16 spp
VOL_BOX_SPP = 4             # the BVH medium box
VOL_GRID = 64               # the media's grid resolution
FILE_SPP = 4                # the scene files' path and gradpath renders
FILE_RESUME_SPP = 2         # the path and gradpath renders resumed in phase 31
FILE_VOL_SPP = 2            # the volpath file of phase 31
RUNG_SPP = 4                # phase 32: the per-ray volpath rungs at 512x512 (one pass)
RUNG_FILE = dict(spp=8, max_depth=4)  # phase 35's v5 file: two passes of 4 spp
RUNG_BOX_DEPTH = 4          # phase 34: the v5 medium box render whose K3 batches are kept
PERRAY_SPP = 4              # phases 36-37: per-ray path (cbox, icosphere box), cbox gradpath
PERRAY_GRAD_DEPTH = 5       # phase 37: render_gradpath's depth
PERRAY_GRAD_BOX_SPP = 2     # phase 37: the icosphere box through render_gradpath
FINAL_GRID = dict(spp=4, max_depth=6)  # phase 38: trace_volpath_final on the grid scene
FINAL_BOX = dict(spp=1, max_depth=4)   # phase 38: trace_volpath_final on the medium box
TWO_PHASE_CAMERA_SPP = 4    # phase 40: 512x512x4 = 1,048,576 camera rays through two-phase
TWO_PHASE_CUT = 65_536      # phase 40: rays of each set held kernel against plain walk
TWO_PHASE_GRAD_SPP = 2      # phase 40: the icosphere box gradpath with two_phase on and off
POOL_SORT_SPP = {"path": 4, "gradpath": 2}  # phase 41: the icosphere box, pool sorted or not
POOL_SORT_VOL_SPP = 1       # phase 41: the medium box volpath, cut from 4 spp
SHARD_PATH_SPP = 4          # phase 42: the cbox through render_soa_sharded / render_samples_sharded
SHARD_GRAD_SPP = 2          # phase 42: the icosphere box gradpath, banded and sharded,
SHARD_GRAD_DEPTH = 5        # at the cbox_gdpt golden's depth, cut from unbounded
SHARD_GRID = dict(spp=2, max_depth=6)  # phase 42: the grid scene volpath, depth cut from unbounded
WALK_CAMERA = 65_536        # phase 43: the camera rays of phase 8 walked by the XLA walks
WALK_SPP = 1                # phase 44: the icosphere box path with packet=False / max_table_mb=0
FMA_CHECK = 4096            # phase 45: values the FMA-peak kernel is held to its plain version on
TOOL_POOL = 1 << 18         # phases 47-49: the captured wavefront pool, the reference tools' default
TOOL_BOUNCES = 8            # phase 46: bounces replayed, the material box's depth
OCC_SPP_PATH = 2            # phase 50: occupancy_report's spp (the reference's defaults),
OCC_SPP_GDPT = 1
OCC_SPP_VOL = 1             # and the grid scene's volpath, cut from its 2
# The kernel behind each row of the kernels line, in its order: a part of
# its mangled name (K3 and K4 as timed, without counts; K5 super32 = mode
# 4, leaf24 = mode 9).
KERNEL_ENTRIES = (
    ("K1", "intersect_brute_kernel"), ("K2", "occluded_brute_kernel"),
    ("K3 closest", "packet_trace_kernelILi32ELb0ELb0E"),
    ("K3 any hit", "packet_trace_kernelILi32ELb1ELb0E"),
    ("K4 closest", "packet_trace_dual_kernelILb0ELb0E"),
    ("K4 any hit", "packet_trace_dual_kernelILb1ELb0E"),
    ("K5 super32", "visit_microbench_kernelILi4E"), ("K5 leaf24", "visit_microbench_kernelILi9E"),
    ("P1 primary", "path_primary"), ("P2 after_hit", "path_after_hit"),
    ("P3 after_shadow", "path_after_shadow"), ("fma_peak", "fma_peak_kernel"))


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, n):
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _time_ms(fn, calls, reps=5):
    """(device ms per call, host-bound ms per call). The first replays a
    CUDA graph of `calls` calls `reps` times, so no host launch overhead
    sits between them; the second times eager calls back to back."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm the allocator outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()

    def replay():
        for _ in range(reps):
            graph.replay()

    def eager():
        for _ in range(calls):
            fn()

    return _events_ms(replay, calls * reps), _events_ms(eager, calls)


def _brute_bits(a):
    import torch

    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _compare_k1(got, ref, label):
    """K1 against its plain version: 0 rays may differ in the bits of t,
    u, v or the normal, or in prim (the same operations in the same order
    with the same tie rule). Returns the max abs error (0)."""
    import torch

    bad = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    for a, b in zip(got, ref):
        bad |= _brute_bits(a) != _brute_bits(b)
    n_bad = int(bad.sum())
    err = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(got, ref))
    print(f"  K1 {label}: {n_bad} of {got[0].numel()} rays differ, max abs err {err:.3g}, "
          f"hits {float((ref[1] >= 0).float().mean()):.4f}")
    if n_bad or not bool(torch.isfinite(got[0]).all()):
        raise AssertionError(f"K1 disagrees with its plain version on {label}")
    return err


def _compare_k2(got, ref, label, live):
    """K2 against its plain version: 0 rays may differ."""
    n_bad = int((got != ref).sum())
    print(f"  K2 {label}: {n_bad} of {got.numel()} rays differ, blocked "
          f"{float(ref.mean()):.4f}, live {float(live.float().mean()):.4f}")
    if n_bad:
        raise AssertionError(f"K2 disagrees with its plain version on {label}")
    return float((got - ref).abs().max())


def _dead_lanes(n, share, layout, dev, seed):
    """A mask of dead lanes: `share` of them, one by one or in whole warps."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    if layout == "warps":
        return (torch.rand((n + 31) // 32, generator=gen, device=dev) < share).repeat_interleave(
            32)[:n]
    return torch.rand(n, generator=gen, device=dev) < share


def _brute_work(kind, args):
    """(live lanes, operations, bytes) of one K1 or K2 call, from its
    inputs: 52 operations per ray-triangle and 40 per ray-sphere pair that
    the live rays test (K2 stops at a ray's first blocking triangle; the
    plain version finds it), and the bytes the call must move: tfar of
    every lane, the six ray components of the live lanes, every output (K1
    28 B a lane, K2 4 B)."""
    import torch

    from gdpt_tpu_torch.accel import brute_kernels as bk

    tri, sph, n_tris, n_sph, *rays, tfar, tnear = args
    n = tfar.shape[0]
    tn = float(torch.tensor(tnear, dtype=torch.float32))
    live = tfar > tn
    n_live = int(live.sum())
    if kind == "K1":
        return (n_live, n_live * (n_tris * OPS_PER_TRI_PAIR + n_sph * OPS_PER_SPH_PAIR),
                4 * n + 24 * n_live + 28 * n)
    ops = 0.0
    blk = torch.zeros(n, dtype=torch.bool, device=tfar.device)
    if n_tris:
        hit = bk._tri_test_rows(tri, n_tris, tuple(rays[:3]), tuple(rays[3:]), tn, tfar)[3]
        blk = hit.any(dim=0)
        tested = torch.where(blk, hit.int().argmax(dim=0) + 1, n_tris)
        ops += float(tested[live].sum()) * OPS_PER_TRI_PAIR
    if n_sph:
        ops += float((live & ~blk).sum()) * n_sph * OPS_PER_SPH_PAIR
    return n_live, ops, 4 * n + 24 * n_live + 4 * n


def _report_profile(prof, wall_us, phase, what, ours, ours_label, card, iters=None):
    """Device time by kernel name, kernel launches (per iteration, given
    `iters`), and the device's busy share of the profiled wall time;
    `ours` picks this repo's kernels."""
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: getattr(e, "self_device_time_total", 0) for e in kernels}
    total = sum(dev_us.values())
    if not total:
        print(f"phase {phase}: the profiler saw no device time: not measured")
        return
    count = sum(e.count for e in kernels)
    mine = sum(t for k, t in dev_us.items() if ours in k)
    per_iter = f" ({count / iters:.1f} per iteration)" if iters else ""
    print(f"phase {phase}: {what} under torch.profiler on {card}: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {total / 1e3:.1f} ms ({total / wall_us:.3f} of wall), "
          f"{count} kernel launches{per_iter}, {ours_label} {mine / 1e3:.2f} ms "
          f"({mine / total:.3f} of device time)")
    for key, t in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {t / 1e3:8.2f} ms  {key[:90]}")


def _profile_one_sample(render, presets, card):
    """Phase 6: where one 512x512 cbox sample's time goes."""
    from torch.profiler import ProfilerActivity, profile

    scene = presets.cornell_box(512, 512, spp=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render.render(scene, seed=1, device="cuda")
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(prof, wall_us, 6, "1 spp 512x512 cbox", "brute_kernel", "K1+K2", card)


def _kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,  # no library call does the kernel's work
    }


def _fused_stages(scene_d, sc, seed=0x9E3779B9, sample0=3):
    """Phase 2's walk of one sample of scene_d (on the card) through
    path_fused.schedule: each stage kernel against its plain stage on a
    copy of the same lane state, every bit of the (31, n) state. Returns
    the stages as (kind, its FUSED_BYTES key, a call of the kernel and
    one of the plain stage on a given state, the state it starts from)."""
    import numpy as np
    import torch

    from gdpt_tpu_torch.integrators import path_fused

    static, cam = scene_d.static, scene_d.device.camera
    dev = cam.sample_to_cam.device
    ys, xs = np.mgrid[0:static.height, 0:static.width]
    lanes = (torch.as_tensor(xs.ravel(), dtype=torch.float32, device=dev),
             torch.as_tensor(ys.ravel(), dtype=torch.float32, device=dev),
             torch.arange(static.width * static.height, device=dev))
    state = torch.zeros((path_fused.N_ROWS, lanes[0].shape[0]), device=dev)
    stages = []
    for name, k, args in path_fused.schedule(static, sc, state):
        def kernel(s, k=k, args=args):
            path_fused.KERNELS[k](path_fused._Launch(static, cam, sc, s, lanes, seed, sample0),
                                  *args)

        def plain(s, k=k, args=args):
            path_fused.PLAIN[k](static, cam, sc, s, lanes, seed, sample0, *args)

        a, b = state.clone(), state.clone()
        plain(a)
        kernel(b)
        torch.cuda.synchronize()
        bad = (a.view(torch.int32) != b.view(torch.int32)).any(dim=0)
        if bool(bad.any()):
            rows = (a.view(torch.int32) != b.view(torch.int32)).any(dim=1).nonzero().ravel()
            raise AssertionError(f"{name}: the stage kernel differs from its plain stage on "
                                 f"{int(bad.sum())} lanes, in rows {rows.tolist()}")
        kind = path_fused.STAGES[k]
        stages.append((kind, name if name == "after_hit 0" else kind, kernel, plain,
                       state.clone()))
        state.copy_(a)
    return stages


def _brute_phases(card):
    """Phases 2-6: the brute-force path (cbox, K1 and K2, and the path
    integrator's stage kernels P1-P3). Returns the kernels' rows for the
    JSON line: K1's and K2's, and P1's to P3's."""
    import numpy as np
    import torch

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.integrators import path_fused, path_soa, render
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to
    from gdpt_tpu_torch.tools.profile_render import FUSED_BYTES
    from gdpt_tpu_torch.utils.profiling import event_span_ms

    # ---- phase 2: kernels vs plain at the main path's shapes ----
    dev = torch.device("cuda")
    scene = presets.cornell_box(512, 512, spp=SPP_MAIN)
    st = scene.static
    scene_d = scene_to(scene, dev)
    sc = path_soa.scene_soa_from_aos(scene_d)
    g = sc.geom
    n = st.width * st.height
    org, d = _camera_rays(scene, dev)
    soups = (g.tri_soup, g.sph_soup, st.n_tris, st.n_spheres)
    big = torch.full((n,), bk.BIG, device=dev)
    cam_rays = (*org, *d, big)
    k1_err = _compare_k1(bk.intersect_brute(*soups, *cam_rays, 0.0),
                         bk.intersect_brute_plain(*soups, *cam_rays, 0.0), "camera rays")
    hit = bk.intersect_brute(*soups, *cam_rays, 0.0)
    pos, rd, dl, tfar, live = _secondary_rays(org, d, hit[0], hit[1], st.shadow_epsilon)
    eps, seps = st.intersection_epsilon, st.shadow_epsilon
    bounce_rays = (*pos, *rd, big)
    sh_rays = (*pos, *dl, tfar)
    k2_err = _compare_k2(bk.occluded_brute(*soups, *sh_rays, seps),
                         bk.occluded_brute_plain(*soups, *sh_rays, seps), "shadow rays", live)
    for share, layout in ((0.0, "lanes"), (0.5, "lanes"), (0.5, "warps"), (0.93, "lanes"),
                          (0.93, "warps"), (1.0, "lanes")):
        dead = _dead_lanes(n, share, layout, dev, seed=int(share * 100) + len(layout))
        what = f"{share:.2f} dead by {layout}"
        b_far = torch.where(dead, -1.0, big)
        k1_err = max(k1_err, _compare_k1(bk.intersect_brute(*soups, *pos, *rd, b_far, eps),
                                         bk.intersect_brute_plain(*soups, *pos, *rd, b_far, eps),
                                         f"bounce rays, {what}"))
        s_far = torch.where(dead, -1.0, tfar)
        k2_err = max(k2_err, _compare_k2(bk.occluded_brute(*soups, *pos, *dl, s_far, seps),
                                         bk.occluded_brute_plain(*soups, *pos, *dl, s_far, seps),
                                         f"shadow rays, {what}", s_far > seps))
    # A per-ray tnear, 0 or the epsilon by lane, as the wavefront casts
    # primary and bounce rays together.
    lane = _dead_lanes(n, 0.5, "lanes", dev, seed=7)
    k1_err = max(k1_err, _compare_k1(
        bk.intersect_brute(*soups, *pos, *rd, big, torch.where(lane, 0.0, eps)),
        bk.intersect_brute_plain(*soups, *pos, *rd, big, torch.where(lane, 0.0, eps)),
        "bounce rays, per-ray tnear"))
    k2_err = max(k2_err, _compare_k2(
        bk.occluded_brute(*soups, *pos, *dl, tfar, torch.where(lane, 0.0, seps)),
        bk.occluded_brute_plain(*soups, *pos, *dl, tfar, torch.where(lane, 0.0, seps)),
        "shadow rays, per-ray tnear", live))
    torch.cuda.synchronize()
    print("phase 2: K1 and K2 equal their plain versions bit for bit (a scalar and a per-ray "
          "tnear)")
    if not path_fused.supports(st, dev):
        raise AssertionError("the 512x512 cbox is outside path_fused's envelope on the card")
    stages = _fused_stages(scene_d, sc)
    kinds = [kind for kind, *_ in stages]
    print(f"phase 2: P1-P3 equal their plain stages bit for bit on {n} lanes through one "
          f"sample ({', '.join(f'{kinds.count(k)} {k}' for k in path_fused.STAGES)})")

    # ---- phase 3: the brute-force main path on cuda ----
    for counts in (bk.LAUNCHES, path_fused.LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    img, rays = render.render(presets.cornell_box(512, 512, spp=SPP_MAIN), seed=0,
                              device="cuda", return_stats=True)
    wall = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    stage_launches = dict(path_fused.LAUNCHES)
    mean = float(img.mean())
    print(f"phase 3: cbox 512x512 spp {SPP_MAIN}: mean radiance {mean:.6f}, "
          f"wall {wall:.3f} s, rays {rays:.0f}, {rays / wall / 1e6:.2f} Mrays/s, "
          f"launches {launches}, stage kernels {stage_launches} on {card}")
    if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not mean > 0:
        raise AssertionError("main-path image is not finite, not 512x512x3 or black")
    if min(launches.values()) == 0 or min(stage_launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}, "
                             f"{stage_launches}")

    # ---- phase 4: cuda vs cpu render ----
    small = presets.cornell_box(32, 32, spp=2, max_depth=3)
    _cuda_vs_cpu(render, small, 4, "cbox")

    # ---- phase 5: timing beside the bound ----
    k1_args = (*soups, *bounce_rays, eps)
    k2_args = (*soups, *sh_rays, seps)
    k1 = lambda: bk.intersect_brute(*k1_args)  # noqa: E731
    k1p = lambda: bk.intersect_brute_plain(*k1_args)  # noqa: E731
    k2 = lambda: bk.occluded_brute(*k2_args)  # noqa: E731
    k2p = lambda: bk.occluded_brute_plain(*k2_args)  # noqa: E731
    (k1_ms, k1_call), (k2_ms, k2_call) = _time_ms(k1, 100), _time_ms(k2, 100)
    (k1p_ms, _), (k2p_ms, _) = _time_ms(k1p, 10), _time_ms(k2p, 10)
    rows = []
    src = "gdpt_tpu_torch/csrc/brute_intersect.cu"
    for name, src_line, ms, call_ms, pms, kind, args, cnt, err in (
            ("intersect_brute (K1)", "gdpt_tpu/accel/pallas_intersect.py:31", k1_ms, k1_call,
             k1p_ms, "K1", k1_args, launches["intersect"], k1_err),
            ("occluded_brute (K2)", "gdpt_tpu/accel/pallas_intersect.py:223", k2_ms, k2_call,
             k2p_ms, "K2", k2_args, launches["occluded"], k2_err)):
        n_live, ops, nbytes = _brute_work(kind, args)
        rows.append(_kernel_row(name, src, src_line, cnt, err, ms, pms, nbytes, ops))
        print(f"phase 5: {name}: {ms * 1e3:.2f} us/launch on the device "
              f"({call_ms * 1e3:.2f} us per eager wrapper call), plain {pms * 1e3:.1f} us, "
              f"bound {rows[-1]['bound_ms'] * 1e3:.2f} us ({rows[-1]['bound_by']}: "
              f"{ops / 1e9:.3f} Gop, {nbytes / 1e6:.1f} MB, {n_live} of {n} lanes live), "
              f"{cnt / SPP_MAIN:.1f} launches/sample on {card}")
    # The stage kernels a launch, from each state of phase 2's sample; the
    # bound counts bytes only (a stage's few hundred operations a lane
    # take a tenth of its bytes' time at the f32 peak).
    fused_rows = []
    for name, kind, src_line in (
            ("path_primary (P1)", "primary", "gdpt_tpu/integrators/path_soa.py:708"),
            ("path_after_hit (P2)", "after_hit", "gdpt_tpu/integrators/path_soa.py:708"),
            ("path_after_shadow (P3)", "after_shadow", "gdpt_tpu/integrators/path_soa.py:708")):
        mine = [stage for stage in stages if stage[0] == kind]
        ms = [event_span_ms(kernel, lambda s=s: (s.clone(),), reps=20)
              for _, _, kernel, _, s in mine]
        pms = [event_span_ms(plain, lambda s=s: (s.clone(),)) for _, _, _, plain, s in mine]
        nbytes = sum(FUSED_BYTES[key] for _, key, *_ in mine) * n / len(mine)
        fused_rows.append(_kernel_row(name, "gdpt_tpu_torch/csrc/path_fused.cu", src_line,
                                      stage_launches[kind], 0.0, sum(ms) / len(ms),
                                      sum(pms) / len(pms), nbytes, 0))
        row = fused_rows[-1]
        print(f"phase 5: {name}: {row['ms'] * 1e3:.2f} us/launch on the device (the mean of "
              f"{len(mine)} launches of one sample), plain {row['plain_ms'] * 1e3:.1f} us, "
              f"bound {row['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.1f} MB), "
              f"{row['launches'] / SPP_MAIN:.1f} launches/sample on {card}")

    _profile_one_sample(render, presets, card)
    return rows, fused_rows


def _camera_rays(scene, dev):
    """One camera ray per pixel of `scene` (jittered by seed 7), as V3s."""
    import numpy as np
    import torch

    from gdpt_tpu_torch.core import soa
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.scene.build import scene_to

    st = scene.static
    ys, xs = np.mgrid[0:st.height, 0:st.width]
    xs_d = torch.as_tensor(xs.ravel(), dtype=torch.float32, device=dev)
    ys_d = torch.as_tensor(ys.ravel(), dtype=torch.float32, device=dev)
    u0, u1 = soa.uniform2(7, torch.arange(st.width * st.height, device=dev), 0, 0)
    cam = scene_to(scene, dev).device.camera
    return path_soa.primary_rays_soa(st, cam, xs_d, ys_d, u0, u1)


def _secondary_rays(org, d, t, prim, shadow_eps):
    """From the camera hits: random bounce directions (seed 11), and
    shadow rays to random points on the Cornell light quad (y = 548.7,
    x in [213, 343], z in [227, 332]); misses and every eighth lane are
    dead (tfar = -1), as NEE retires lanes. Returns contiguous component
    tuples pos, bounce dir, light dir, and tfar, live."""
    import torch

    from gdpt_tpu_torch.core import soa

    n, dev = t.shape[0], t.device
    pos = soa.where(prim >= 0, org + d * t, org)
    gen = torch.Generator(device=dev).manual_seed(11)
    rd = torch.randn((3, n), generator=gen, device=dev)
    rd = rd / rd.norm(dim=0)
    lp = torch.rand((3, n), generator=gen, device=dev)
    lx, ly, lz = 213.0 + 130.0 * lp[0], torch.full_like(lp[1], 548.7), 227.0 + 105.0 * lp[2]
    to_l = soa.V3(lx, ly, lz) - pos
    dist = soa.length(to_l)
    dl = to_l * (1.0 / dist.clamp_min(1e-20))
    live = (prim >= 0) & (torch.arange(n, device=dev) % 8 != 0)
    tfar = torch.where(live, (1.0 - shadow_eps) * dist, -1.0)
    cont = lambda v: tuple(c.contiguous() for c in v)  # noqa: E731
    return cont(pos), cont(rd.unbind(0)), cont(dl), tfar, live


def _gate_cuda_vs_cpu(a, b, scale, phase, label, what="cuda vs cpu 32x32"):
    import numpy as np

    frac = float(np.isclose(a, b, rtol=1e-3, atol=1e-4).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(scale, 1e-12)
    print(f"phase {phase}: {what} {label}: {frac:.5f} of values within "
          f"rtol 1e-3/atol 1e-4, mean rel diff {mean_rel:.3g}")
    if frac < 0.99 or mean_rel > 1e-3:
        raise AssertionError(f"{what}: the images of the {label} disagree")


def _cuda_vs_cpu(render, scene, phase, label):
    a = render.render(scene, seed=3, device="cuda")
    b = render.render(scene, seed=3, device="cpu")
    _gate_cuda_vs_cpu(a, b, float(b.mean()), phase, label)


def _gradpath_cuda_vs_cpu(render, scene, label, phase=17):
    """Reconstruction and gradients of a gradpath render, cuda against
    cpu; the gradients' means (differences near zero) are held to 0.1% of
    the primal's mean."""
    a, aux_a = render.render(scene, seed=3, device="cuda", return_aux=True)
    b, aux_b = render.render(scene, seed=3, device="cpu", return_aux=True)
    scale = float(aux_b["primal"].mean())
    _gate_cuda_vs_cpu(a, b, scale, phase, f"gradpath {label}, recon")
    for name in ("gx", "gy"):
        _gate_cuda_vs_cpu(aux_a[name], aux_b[name], scale, phase, f"gradpath {label}, {name}")


def _compare_k3(pk, tab, rays, n_tris, any_hit, label):
    """K3 against its plain version on the same rays. Both walk the same
    nodes in the same order with separately rounded operations and the
    same tie rules, so no ray may differ in t, prim or its visit counts.
    Returns (max abs err of t, counts)."""
    import torch

    t, prim, cnt = pk.trace_packets(tab, *rays, n_tris=n_tris, any_hit=any_hit, counts=True)
    rt, rprim, rcnt = pk.trace_packets_plain(tab, *rays, n_tris=n_tris, any_hit=any_hit,
                                             counts=True)
    torch.cuda.synchronize()
    n = t.shape[0]
    bad_t = int((t.view(torch.int32) != rt.view(torch.int32)).sum())
    bad_prim = int((prim != rprim).sum())
    bad_cnt = int((cnt != rcnt).any(dim=1).sum())
    err = float((t - rt).abs().max()) if n else 0.0
    mean = cnt.float().mean(dim=0).tolist()
    print(f"  K3 {'any-hit' if any_hit else 'closest'} {label}: {n} rays, t differs on {bad_t}, "
          f"prim on {bad_prim}, visit counts on {bad_cnt}, max abs err of t {err:.3g}, hits "
          f"{float((rprim >= 0).float().mean()):.4f}; per ray {mean[0]:.1f} super visits, "
          f"{mean[1]:.1f} leaf visits, {mean[2]:.1f} primitive tests, deepest stack "
          f"{int(cnt[:, 3].max())} of {tab.stack_n // tab.width}")
    if bad_t + bad_prim + bad_cnt or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"K3 differs from its plain version on {label}")
    return err, cnt


def _brute_over_geo9(bk, geo9, rays, tnear):
    """Closest t of every ray over every triangle row of geo9, in chunks
    of plain PyTorch (the row tester of the brute kernels' plain version)."""
    import torch

    o, d = tuple(rays[:3]), tuple(rays[3:6])
    best = torch.full_like(rays[0], 3e37)
    for lo in range(0, geo9.shape[0], 4096):
        soup = geo9[lo:lo + 4096].T.contiguous()
        t, _, _, hit = bk._tri_test_rows(soup, soup.shape[1], o, d, tnear, 3e37)
        best = torch.minimum(best, torch.where(hit, t, 3e37).amin(dim=0))
    return best


def _small_table_checks(pk, dev):
    """K3 vs plain off the main path's shapes: a 16-wide table, and a
    32-wide table with more than 8 in-table spheres (n_tris given)."""
    import torch

    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    errs = []
    spheres = [((60.0 + 48.0 * i, 40.0 + 30.0 * (i % 3), 120.0 + 35.0 * i), 30.0)
               for i in range(10)]
    for label, wide, sph in (("16-wide table", 16, ()), ("in-table spheres", 32, spheres)):
        scene = presets.icosphere_box(256, 256, 1, [(3, (368.0, 100.0, 351.0), 100.0)], sph)
        st = scene.static
        g = trs.geom_soa_from_aos(scene_to(scene, dev).device.geom, wide=wide)
        n_tris = trs._table_n_tris(st)
        if bool(sph) != (n_tris is not None) or g.packet.width != wide:
            raise AssertionError(f"{label}: the table is not the one asked for")
        org, d = _camera_rays(scene, dev)
        n = org.x.shape[0]
        cam = (*(c.contiguous() for c in org), *(c.contiguous() for c in d),
               torch.zeros(n, device=dev), torch.full((n,), 3e37, device=dev))
        t, prim = pk.trace_packets(g.packet, *cam, n_tris=n_tris)
        if sph and not bool((prim >= st.n_tris).any()):
            raise AssertionError("no camera ray hit an in-table sphere")
        pos, rd, dl, tfar, _ = _secondary_rays(org, d, t, prim, st.shadow_epsilon)
        eps = torch.full((n,), st.intersection_epsilon, device=dev)
        errs.append(_compare_k3(pk, g.packet, cam, n_tris, False, f"{label}, camera rays")[0])
        if not sph:
            # A table whose stack_n understates its depth: the kernel
            # must report the full stack, never drop the push.
            shallow = g.packet._replace(stack_n=wide)
            for counts in (True, False):
                try:
                    pk.trace_packets(shallow, *cam, counts=counts)
                    pk.check_overflow()
                except RuntimeError as e:
                    if "stack" not in str(e):
                        raise
                else:
                    raise AssertionError("K3 dropped a push past its stack without an error")
            print(f"  K3 {label}: a one-entry stack raises (counts on and off)")
        errs.append(_compare_k3(pk, g.packet, (*pos, *rd, eps, torch.full_like(eps, 3e37)),
                                n_tris, False, f"{label}, bounce rays")[0])
        _compare_k3(pk, g.packet, (*pos, *dl, eps, tfar), n_tris, True,
                    f"{label}, shadow rays")
    return max(errs)


def _walk_work(pk, tab, rays, any_hit):
    """The work of one walk over `rays`, counted by the plain version
    whatever implements the kernel: (operations, bytes, table rows read,
    visits). Bytes: eight ray arrays in (no start refs), t and prim out,
    and each table row these rays' visits read, once."""
    import torch

    n, rows = rays[0].shape[0], tab.table.shape[0]
    read = torch.zeros(rows, dtype=torch.bool, device=rays[0].device)
    cnt = pk.trace_packets_plain(tab, *rays, any_hit=any_hit, counts=True, rows_read=read)[2]
    cnt = cnt.sum(dim=0).tolist()
    ops = cnt[0] * tab.width * OPS_PER_BOX + cnt[2] * OPS_PER_TRI_PAIR
    n_read = int(read.sum())
    return ops, 40 * n + n_read * 512, n_read, cnt[0] + cnt[1]


def _time_walk(pk, pt, tab, r, rs, any_hit, dual, phase, name, source, replaces, launches,
               spp, err, card):
    """Time one walk kernel (K3, or K4 with dual) on rays `r` and their
    morton-sorted copy `rs` by CUDA graph replay, beside the plain version
    and the bound counted from these rays' own visits. Returns its row and
    its time per visit per ray in ns."""
    from gdpt_tpu_torch.core.soa import V3

    n, rows = r[0].shape[0], tab.table.shape[0]
    walk = lambda rr: pk.trace_packets(tab, *rr, any_hit=any_hit, dual=dual)  # noqa: E731
    plain = pk.trace_packets_dual_plain if dual else pk.trace_packets_plain
    ms_sorted, _ = _time_ms(lambda: walk(rs), 10, 3)
    ms_unsorted, _ = _time_ms(lambda: walk(r), 10, 3)
    full = (pt.occluded_packet if any_hit else pt.intersect_packet)
    o3, d3 = V3(*r[:3]), V3(*r[3:6])
    full(tab, o3, d3, r[6], r[7], dual=dual)
    ms_full = _events_ms(lambda: [full(tab, o3, d3, r[6], r[7], dual=dual) for _ in range(5)], 5)
    plain(tab, *rs, any_hit=any_hit)
    ms_plain = _events_ms(lambda: plain(tab, *rs, any_hit=any_hit), 1)
    ops, nbytes, n_read, visits = _walk_work(pk, tab, rs, any_hit)
    row = _kernel_row(name, source, replaces, launches, err, ms_sorted, ms_plain, nbytes, ops)
    print(f"phase {phase}: {name}: {ms_sorted * 1e3:.1f} us/launch on sorted rays, "
          f"{ms_unsorted * 1e3:.1f} us unsorted, {ms_full * 1e3:.1f} us per eager wrapper "
          f"call with sort, unsort and hit attributes; plain (eager, with its host "
          f"syncs) {ms_plain * 1e3:.0f} us; bound {row['bound_ms'] * 1e3:.2f} us "
          f"({row['bound_by']}: {ops / 1e9:.2f} Gop, {nbytes / 1e6:.1f} MB = 40 B/ray + "
          f"{n_read} of {rows} rows read); {visits / n:.2f} visits per ray = "
          f"{ms_sorted * 1e6 / max(visits, 1):.4f} ns per visit per ray; "
          f"{launches / spp:.1f} launches/sample on {card}")
    return row, ms_sorted * 1e6 / max(visits, 1)


def _bvh_phases(card):
    """Phases 7-12: the BVH path (packet table, K3, wavefront renderer)
    at full size. Returns K3's rows for the JSON line, and what the
    gradient-domain phases reuse: the scene and its ray sets."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import packet_trace as pt
    from gdpt_tpu_torch.core.soa import V3
    from gdpt_tpu_torch.integrators import path_soa, render
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    dev = torch.device("cuda")

    # ---- phase 7: the scene, its BVH and its packet table ----
    t0 = time.perf_counter()
    scene = presets.icosphere_box(512, 512, SPP_BVH, presets.ICOSPHERE_BALLS)
    t_scene = time.perf_counter() - t0
    st = scene.static
    t0 = time.perf_counter()
    scene_dev = scene_to(scene, dev)
    sc = path_soa.scene_soa_from_aos(scene_dev)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    tab = sc.geom.packet
    rows = tab.table.shape[0]
    print(f"phase 7: icosphere box: {st.n_tris} triangles, {scene.device.geom.bvh_count.shape[0]} "
          f"BVH nodes by the {scene.bvh_builder} builder, scene build {t_scene:.2f} s; packet "
          f"table {rows} rows x 128 ({rows * 512 / 1e6:.1f} MB), width {tab.width}, "
          f"stack_n {tab.stack_n}, table and shading tables {t_table:.2f} s")
    if st.use_brute_force or st.n_tris < 400_000 or scene.bvh_builder != "native":
        raise AssertionError("the BVH scene is not the full-size one, or not natively built")

    # ---- phase 8: K3 vs plain, and vs brute force ----
    org, d = _camera_rays(scene, dev)
    n = org.x.shape[0]
    big = torch.full((n,), 3e37, device=dev)
    cam = (*(c.contiguous() for c in org), *(c.contiguous() for c in d),
           torch.zeros(n, device=dev), big)
    err, _ = _compare_k3(pk, tab, cam, None, False, "camera rays")
    t_cam, prim_cam = pk.trace_packets(tab, *cam)
    pos, rd, dl, tfar, _ = _secondary_rays(org, d, t_cam, prim_cam, st.shadow_epsilon)
    eps_i = torch.full((n,), st.intersection_epsilon, device=dev)
    eps_s = torch.full((n,), st.shadow_epsilon, device=dev)
    bounce = (*pos, *rd, eps_i, big)
    shadow = (*pos, *dl, eps_s, tfar)
    err_b, _ = _compare_k3(pk, tab, bounce, None, False, "bounce rays")
    err_s, _ = _compare_k3(pk, tab, shadow, None, True, "shadow rays")
    err_c = max(err, err_b)
    err_c = max(err_c, _small_table_checks(pk, dev))
    # Brute force over every triangle is the oracle of any walk. A ray
    # that grazes a leaf group's tight f32 box can be a hit there and a
    # box-miss in the walk: the slab test's bound*inv - org*inv cancels
    # to a few ulps of org*inv, and an axis-aligned wall has a box of
    # zero thickness. Such rays are counted, not chased. The ones seen
    # leave a wall at a grazing angle and re-hit that wall just past
    # tnear; any other kind is held to 0.01%, all kinds to 0.1%.
    pick = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(5),
                          device=dev)[:N_BRUTE_SAMPLE]
    sample = tuple(c[pick].contiguous() for c in bounce)
    t_k3 = pk.trace_packets(tab, *sample)[0]
    t_bf = _brute_over_geo9(bk, tab.geo9, sample, st.intersection_epsilon)
    off = ~torch.isclose(t_k3, t_bf, rtol=1e-5, atol=0.0)
    missed = int((off & (t_bf < t_k3)).sum())
    at_eps = int((off & (t_bf < 2.0 * st.intersection_epsilon)).sum())
    n_off = int(off.sum())
    span = (f", brute-force t of these from {float(t_bf[off].min()):.4f} to "
            f"{float(t_bf[off].max()):.4f}" if n_off else "")
    print(f"  K3 closest vs brute force over {tab.geo9.shape[0]} triangles on {N_BRUTE_SAMPLE} "
          f"bounce rays: {n_off} beyond rtol 1e-5 ({missed} hits the walk missed, {at_eps} of "
          f"them re-hits of the ray's own wall within 2 tnear = "
          f"{2.0 * st.intersection_epsilon:.4f}{span})")
    if n_off - at_eps > N_BRUTE_SAMPLE // 10000 or n_off > N_BRUTE_SAMPLE // 1000:
        raise AssertionError("K3 disagrees with brute force over all triangles")
    print("phase 8: K3 agrees with its plain version and with brute force")

    # ---- phase 9: the BVH main path on cuda ----
    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    if path_soa.scene_soa_from_aos(scene_to(scene, "cuda")) is not sc:
        raise AssertionError("the scene's tables of phase 7 were not kept for the render")
    t0 = time.perf_counter()
    img, rays = render.render(scene, spp=SPP_BVH, seed=0, device="cuda", return_stats=True)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    mean = float(img.mean())
    iters = path_soa.render_soa_wavefront.last_iters
    occ = path_soa.render_soa_wavefront.last_occupancy
    print(f"phase 9: icosphere box 512x512 spp {SPP_BVH}: mean radiance {mean:.6f}, "
          f"wall {wall:.3f} s (tables kept from phase 7, {t_table:.2f} s), rays {rays:.0f}, "
          f"{rays / wall / 1e6:.2f} Mrays/s, launches {launches}, {iters} wavefront "
          f"iterations, mean occupancy {occ:.3f} on {card}")
    if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not mean > 0:
        raise AssertionError("BVH main-path image is not finite, not 512x512x3 or black")
    if min(launches["packet_intersect"], launches["packet_occluded"]) == 0:
        raise AssertionError(f"a K3 mode of the BVH main path was never launched: {launches}")

    # ---- phase 10: cuda vs cpu render of a small BVH scene ----
    _cuda_vs_cpu(render, presets.icosphere_box(32, 32, 2, [(3, (368.0, 100.0, 351.0), 100.0)]),
                 10, "icosphere box (1,280 + 12 triangles)")

    # ---- phase 11: timing beside the bound ----
    def presorted(r, tab=tab):
        keys = pt._morton_keys(tab, V3(*r[:3]), V3(*r[3:6]))
        perm = torch.argsort(torch.where(r[7] >= r[6], keys, 2 ** 30), stable=True)
        return tuple(c[perm].contiguous() for c in r)

    out_rows, ns_visit = [], []
    for name, mode, r, any_hit, err_k in (
            ("trace_packets closest (K3)", "packet_intersect", bounce, False, err_c),
            ("trace_packets any-hit (K3)", "packet_occluded", shadow, True, err_s)):
        row, ns = _time_walk(
            pk, pt, tab, r, presorted(r), any_hit, False, 11, name,
            "gdpt_tpu_torch/csrc/packet_trace.cu", "gdpt_tpu/accel/packet_trace.py:486",
            launches[mode], SPP_BVH, err_k, card)
        out_rows.append(row)
        ns_visit.append(ns)

    # ---- phase 12: one wavefront chunk under the profiler ----
    n_pix = st.width * st.height
    total = n_pix * SPP_BVH
    state = path_soa._wavefront_state(n_pix, path_soa._pool_width(total), total, 1, dev)
    cam_arrays = scene_dev.device.camera
    for _ in range(8):  # fill the pool to its steady state first
        state = path_soa._wavefront_body(st, cam_arrays, sc, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            state = path_soa._wavefront_body(st, cam_arrays, sc, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(prof, wall_us, 12, "8 wavefront iterations of the icosphere box",
                    "packet_trace_kernel", "K3", card)
    return out_rows, dict(scene=scene, scene_dev=scene_dev, cam=cam, bounce=bounce,
                          shadow=shadow, presorted=presorted, k3_ns_per_visit=ns_visit)


def _compare_k4(pk, tab, rays, any_hit, label):
    """K4 against its plain version and against K3 on the same rays and
    16-wide table: t, prim and the visit counts are held equal bit for
    bit (the same walk per ray). Returns the max abs err of t."""
    import torch

    got = pk.trace_packets(tab, *rays, any_hit=any_hit, counts=True, dual=True)
    ref = pk.trace_packets_dual_plain(tab, *rays, any_hit=any_hit, counts=True)
    solo = pk.trace_packets(tab, *rays, any_hit=any_hit, counts=True)
    torch.cuda.synchronize()
    n = got[0].shape[0]
    bad = [[int((a != b).reshape(n, -1).any(dim=1).sum()) for a, b in zip(got, other)]
           for other in (ref, solo)]
    mean = got[2].float().mean(dim=0).tolist()
    print(f"  K4 {'any-hit' if any_hit else 'closest'} {label}: {n} rays; vs plain: t differs on "
          f"{bad[0][0]}, prim on {bad[0][1]}, counts on {bad[0][2]}; vs K3: t {bad[1][0]}, prim "
          f"{bad[1][1]}, counts {bad[1][2]}; hits {float((ref[1] >= 0).float().mean()):.4f}; per "
          f"ray {mean[0]:.1f} super visits, {mean[1]:.1f} leaf visits, {mean[2]:.1f} primitive "
          f"tests, deepest stack {int(got[2][:, 3].max())} of {tab.stack_n // tab.width}")
    if sum(map(sum, bad)) or not bool(torch.isfinite(got[0]).all()):
        raise AssertionError(f"K4 disagrees with its plain version or with K3 on {label}")
    return float((got[0] - ref[0]).abs().max())


def _k5_differ(got, ref):
    """Rays whose K5 result differs from the plain version's in any bit
    of t, prim or the mask word."""
    import torch

    torch.cuda.synchronize()
    return [int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(got, ref)]


def _gradpath_phases(card, ctx):
    """Phases 13-19: the gradient-domain path (5-path lockstep, Poisson
    solve) on the icosphere box, the dual walk K4 on its 16-wide table
    and the visit microbenchmark K5. Returns K4's and K5's rows."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import packet_trace as pt
    from gdpt_tpu_torch.integrators import gdpt_soa, path_soa, render
    from gdpt_tpu_torch.ops import poisson
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to
    from gdpt_tpu_torch.tools import visit_microbench as vm

    dev = torch.device("cuda")
    scene_dev = ctx["scene_dev"]
    cam, bounce, shadow = ctx["cam"], ctx["bounce"], ctx["shadow"]
    st = scene_dev.static
    sc32 = path_soa.scene_soa_from_aos(scene_dev)
    tab32 = sc32.geom.packet

    # ---- phase 13: the 16-wide table; K4 vs plain and vs K3 ----
    t0 = time.perf_counter()
    sc16 = path_soa.scene_soa_from_aos(scene_dev, wide=16)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    tab16 = sc16.geom.packet
    rows16 = tab16.table.shape[0]
    print(f"phase 13: 16-wide packet table {rows16} rows x 128 ({rows16 * 512 / 1e6:.1f} MB), "
          f"stack_n {tab16.stack_n}, table and shading tables {t_table:.2f} s")
    if tab16.width != 16:
        raise AssertionError("the 16-wide table is not 16-wide")
    err4 = {False: 0.0, True: 0.0}
    for label, r, any_hit in (("camera rays", cam, False), ("bounce rays", bounce, False),
                              ("shadow rays", shadow, True)):
        for n in (r[0].shape[0], r[0].shape[0] - 1):
            cut = tuple(c[:n].contiguous() for c in r)
            err4[any_hit] = max(err4[any_hit], _compare_k4(pk, tab16, cut, any_hit, label))
    try:
        pk.trace_packets(tab32, *bounce, dual=True)
    except ValueError as e:
        print(f"  K4 on the 32-wide table raises: {e}")
    else:
        raise AssertionError("the dual walk took a 32-wide table")
    print("phase 13: K4 agrees with its plain version and with K3")

    # ---- phase 14: K5 vs plain in every mode, then the timed tool run ----
    small = vm.random_rays(tab32, 65_536, seed=1)
    err5 = dict.fromkeys(vm.MODES, 0.0)
    for tab in (tab32, tab16):
        for mode in vm.MODES:
            got = vm.visit_microbench(tab, *small, 256, mode)
            ref = vm.visit_microbench_plain(tab, *small, 256, mode)
            bad = _k5_differ(got, ref)
            err5[mode] = max(err5[mode], float((got[0] - ref[0]).abs().max()))
            print(f"  K5 {mode} on the {tab.width}-wide table: 65536 rays x 256 visits: t differs "
                  f"on {bad[0]}, prim on {bad[1]}, mask word on {bad[2]}; hits "
                  f"{float((ref[1] >= 0).float().mean()):.4f}, word set on "
                  f"{float((ref[2] != 0).float().mean()):.4f}")
            if sum(bad):
                raise AssertionError(f"K5 disagrees with its plain version in mode {mode}")
    print("phase 14: K5 agrees with its plain version in every mode")
    for k in vm.LAUNCHES:
        vm.LAUNCHES[k] = 0
    n_rays, n_visits = 262_144, 2048
    timed = {tab.width: vm.run(tab, n_rays, n_visits, out=lambda m: print("  " + m))
             for tab in (tab32, tab16)}
    k5_launches = dict(vm.LAUNCHES)
    if min(k5_launches.values()) == 0:
        raise AssertionError(f"the microbenchmark's entry point left a mode out: {k5_launches}")
    ns3 = ctx["k3_ns_per_visit"]
    print(f"phase 14: K5 on {card}: launches by mode {k5_launches}; K3 (a lane group per ray) "
          f"spends {ns3[0]:.4f} (closest) and {ns3[1]:.4f} (any hit) ns per visit per ray on "
          f"the 32-wide table; K5's visits of one row shared by every ray cost "
          f"{timed[32]['super32'][1]:.5f} (super32) and {timed[32]['leaf24'][1]:.5f} (leaf24) ns "
          f"coherent, the bare loop {timed[32]['empty'][1]:.5f}")
    k5_rows = []
    rays_t = vm.random_rays(tab32, n_rays)
    for mode in ("super32", "leaf24"):  # the 32-wide table's own two visits
        ref = []
        ms_plain = _events_ms(
            lambda: ref.append(vm.visit_microbench_plain(tab32, *rays_t, n_visits, mode)), 1)
        bad = _k5_differ(vm.visit_microbench(tab32, *rays_t, n_visits, mode), ref[0])
        print(f"  K5 {mode} on the 32-wide table: {n_rays} rays x {n_visits} visits: t differs "
              f"on {bad[0]}, prim on {bad[1]}, mask word on {bad[2]}")
        if sum(bad):
            raise AssertionError(f"K5 disagrees with its plain version in mode {mode} at full size")
        ops, distinct = vm.visit_work(tab32, n_visits, mode)
        k5_rows.append(_kernel_row(
            f"visit_microbench {mode} (K5)", "gdpt_tpu_torch/csrc/visit_microbench.cu",
            "tools/visit_microbench.py:44", k5_launches[mode], err5[mode], timed[32][mode][0],
            ms_plain, 44 * n_rays + distinct * 512, ops * n_rays))
        print(f"phase 14: K5 {mode}: {timed[32][mode][0]:.3f} ms/launch, plain {ms_plain:.0f} ms, "
              f"bound {k5_rows[-1]['bound_ms']:.3f} ms ({k5_rows[-1]['bound_by']}: "
              f"{ops * n_rays / 1e9:.1f} Gop, {distinct} distinct rows)")

    # ---- phase 15: the gradient-domain main path on cuda (K3) ----
    grad = ctx["scene"]._replace(static=dataclasses.replace(
        st, options=dataclasses.replace(st.options, integrator="gradpath")))
    if path_soa.scene_soa_from_aos(scene_to(grad, "cuda")).geom.packet is not tab32:
        raise AssertionError("the scene's tables of phase 7 were not kept for the render")
    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    recon, aux, rays = render.render(grad, spp=SPP_GRAD, seed=0, device="cuda",
                                     return_aux=True, return_stats=True)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    iters = gdpt_soa._gdpt_wavefront_accum.last_iters
    occ = gdpt_soa._gdpt_wavefront_accum.last_occupancy
    m_recon, m_primal = float(recon.mean()), float(aux["primal"].mean())
    print(f"phase 15: icosphere box 512x512 gradpath spp {SPP_GRAD}: mean recon {m_recon:.6f}, "
          f"mean primal {m_primal:.6f}, wall {wall:.3f} s (tables kept), rays {rays:.0f}, "
          f"{rays / wall / 1e6:.2f} Mrays/s, launches {launches}, {iters} wavefront iterations, "
          f"mean occupancy {occ:.3f} on {card}")
    if recon.shape != (512, 512, 3) or not np.isfinite(recon).all() or not m_primal > 0:
        raise AssertionError("gradpath reconstruction is not finite, not 512x512x3 or black")
    if not all(np.isfinite(a).all() for a in aux.values()) or not np.abs(aux["gx"]).mean() > 0:
        raise AssertionError("gradpath auxiliary buffers are not finite, or the gradients zero")
    if abs(m_recon - m_primal) > 0.02 * m_primal:
        raise AssertionError("the reconstruction lost the primal's mean (the DC term)")
    if min(launches["packet_intersect"], launches["packet_occluded"]) == 0 or \
            launches["packet_dual_intersect"] + launches["packet_dual_occluded"]:
        raise AssertionError(f"the gradpath main path did not go through K3 alone: {launches}")
    grad_launches = launches
    ctx["grad_rays"] = rays  # phase 45's bench row casts these rays again
    imgs = [torch.as_tensor(aux[k], device=dev) for k in ("primal", "gx", "gy")]
    solve = lambda: poisson.screened_poisson_solve(*imgs, st.options.gdpt_alpha)  # noqa: E731
    solve()
    print(f"phase 15: screened-Poisson solve alone at 512x512: "
          f"{_events_ms(lambda: [solve() for _ in range(10)], 10):.3f} ms on the device")

    # ---- phase 16: 16-wide table, solo then dual ----
    outs = {}
    for dual in (False, True):
        if path_soa.scene_soa_from_aos(scene_to(grad, "cuda"), 16, dual).geom.packet is not tab16:
            raise AssertionError("the 16-wide table was not kept for the render")
        for k in pk.LAUNCHES:
            pk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        outs[dual] = render.render(grad, spp=1, seed=0, device="cuda", return_aux=True,
                                   return_stats=True, packet_wide=16, packet_dual=dual)
        wall = time.perf_counter() - t0
        outs[dual] += (dict(pk.LAUNCHES),)
        print(f"phase 16: gradpath 1 spp, 16-wide table, {'dual (K4)' if dual else 'solo (K3)'}: "
              f"wall {wall:.3f} s, rays {outs[dual][2]:.0f}, {outs[dual][2] / wall / 1e6:.2f} "
              f"Mrays/s, launches {outs[dual][3]}")
    same = np.array_equal(outs[True][0], outs[False][0]) and all(
        np.array_equal(outs[True][1][k], outs[False][1][k]) for k in outs[True][1])
    dual_launches = outs[True][3]
    if not same or outs[True][2] != outs[False][2]:
        raise AssertionError("the dual walk's render differs from the solo walk's")
    if min(dual_launches["packet_dual_intersect"], dual_launches["packet_dual_occluded"]) == 0 \
            or dual_launches["packet_intersect"] + dual_launches["packet_occluded"]:
        raise AssertionError(f"the dual render did not go through K4 alone: {dual_launches}")
    print("phase 16: the dual render equals the solo render, through K4 alone")

    # ---- phase 17: cuda vs cpu gradpath, brute force and BVH ----
    _gradpath_cuda_vs_cpu(render, presets.cornell_box(32, 32, spp=2, max_depth=3,
                                                      integrator="gradpath"), "cbox")
    _gradpath_cuda_vs_cpu(
        render, presets.icosphere_box(32, 32, 2, [(3, (368.0, 100.0, 351.0), 100.0)],
                                      integrator="gradpath", max_depth=3),
        "icosphere box (1,280 + 12 triangles)")

    # ---- phase 18: K4 beside K3 on the 16-wide table ----
    rows = []
    for r, any_hit, mode in ((bounce, False, "intersect"), (shadow, True, "occluded")):
        rs = ctx["presorted"](r, tab16)
        what = "any-hit" if any_hit else "closest"
        for dual, name, src, line, cnt in (
                (False, f"trace_packets {what} (K3), 16-wide table",
                 "gdpt_tpu_torch/csrc/packet_trace.cu", "gdpt_tpu/accel/packet_trace.py:486",
                 outs[False][3][f"packet_{mode}"]),
                (True, f"trace_packets dual {what} (K4)",
                 "gdpt_tpu_torch/csrc/packet_trace_dual.cu", "gdpt_tpu/accel/packet_trace.py:829",
                 dual_launches[f"packet_dual_{mode}"])):
            row, _ = _time_walk(pk, pt, tab16, r, rs, any_hit, dual, 18, name, src, line, cnt, 1,
                                err4[any_hit], card)
            if dual:
                rows.append(row)

    # ---- phase 19: the pool's own batches, then a chunk under the profiler ----
    sc = sc32
    n_pix = st.width * st.height
    total = n_pix * SPP_GRAD
    camera = scene_dev.device.camera
    used = st.used_material_kinds
    state = gdpt_soa._gdpt_wavefront_state(st, camera, sc, total, 1,
                                           path_soa._pool_width(total, 1 << 17))
    # Fill the pool to its steady state first, keeping the last batch of
    # each size and mode as the walk's wrapper receives it (scrubbed,
    # sorted, retired lanes at the back with tfar = -1).
    batches = {}
    walk = pk.trace_packets

    def recording(tab, *rays, **kw):
        batches[(rays[0].shape[0], bool(kw.get("any_hit")))] = rays
        return walk(tab, *rays, **kw)

    pk.trace_packets = recording
    try:
        for _ in range(6):
            state = gdpt_soa._gdpt_wavefront_body(st, camera, sc, used, state)
    finally:
        pk.trace_packets = walk
    pool = state["pending"].shape[0]
    if {(pool, False), (pool, True), (5 * pool, False), (8 * pool, False)} - set(batches):
        raise AssertionError(f"the pool's casts were not all seen: {sorted(batches)}")
    for (n, any_hit), rays in sorted(batches.items()):
        dead = float((rays[7] < rays[6]).float().mean())
        label = f"pool batch of {n // pool} x {pool} lanes, {dead:.4f} dead"
        _compare_k3(pk, tab32, rays, None, any_hit, label + ", 32-wide table")
        _compare_k4(pk, tab16, rays, any_hit, label)
    print("phase 19: K3 and K4 agree with their plain versions on the pool's own batches")
    # Launches per gradpath iteration (phase 15): the base, shadow and 8n
    # probe/replay casts every iteration, the 5n primary cast in those that
    # refill the pool.
    per_iter = {(pool, False): 1.0, (pool, True): 1.0, (8 * pool, False): 1.0,
                (5 * pool, False): (grad_launches["packet_intersect"] - 2 * iters) / iters}
    iter_us = dict.fromkeys(("K3, 32-wide table", "K3, 16-wide table", "K4, 16-wide table"), 0.0)
    for (n, any_hit), rays in sorted(batches.items()):
        dead = float((rays[7] < rays[6]).float().mean())
        work = {}  # K3 and K4 do the same work on the 16-wide table
        for walker, tab, dual in (("K3", tab32, False), ("K3", tab16, False),
                                  ("K4", tab16, True)):
            ms, _ = _time_ms(lambda: pk.trace_packets(tab, *rays, any_hit=any_hit, dual=dual),
                             10, 3)
            if tab.width not in work:
                work[tab.width] = _walk_work(pk, tab, rays, any_hit)
            ops, nbytes, n_read, visits = work[tab.width]
            bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e3
            what = f"{walker}, {tab.width}-wide table"
            iter_us[what] += per_iter.get((n, any_hit), 0.0) * ms * 1e3
            print(f"phase 19: {walker} {'any hit' if any_hit else 'closest'} on the pool batch "
                  f"of {n // pool} x {pool} lanes ({dead:.4f} dead), {tab.width}-wide table: "
                  f"{ms * 1e3:.1f} us/launch by CUDA graph replay, bound {bound * 1e3:.2f} us "
                  f"({ops / 1e9:.3f} Gop, {nbytes / 1e6:.1f} MB, {n_read} rows read), "
                  f"{visits / n:.2f} visits per ray on {card}")
    print(f"phase 19: walk time per gradpath iteration (each batch's time x its launches per "
          f"iteration, {per_iter[(5 * pool, False)]:.4f} for the 5n cast): " + ", ".join(
              f"{k} {v:.1f} us" for k, v in iter_us.items()) + f" on {card}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(6):
            state = gdpt_soa._gdpt_wavefront_body(st, camera, sc, used, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(prof, wall_us, 19, "6 gradpath wavefront iterations of the icosphere box",
                    "packet_trace_kernel", "K3", card)
    print(f"phase 19: K3 launches per gradpath sample: "
          f"{grad_launches['packet_intersect'] / SPP_GRAD:.1f} closest, "
          f"{grad_launches['packet_occluded'] / SPP_GRAD:.1f} any hit "
          f"({grad_launches['packet_intersect'] / iters:.2f} and "
          f"{grad_launches['packet_occluded'] / iters:.2f} per iteration)")
    return rows + k5_rows


def _record_brute_batches(render, bk, scene):
    """Every K1 / K2 call of one render of a brute-force scene on cuda as
    (kind, args), recorded through the wrappers' module attributes, in
    order. A call made while a CUDA graph is captured runs nothing and
    is left out: a graphed pass calls the wrappers for its warm sample
    and again for its capture."""
    import torch

    seen = []
    wrappers = {"K1": bk.intersect_brute, "K2": bk.occluded_brute}

    def recording(kind):
        def call(*args):
            if not torch.cuda.is_current_stream_capturing():
                seen.append((kind, args))
            return wrappers[kind](*args)
        return call

    bk.intersect_brute, bk.occluded_brute = recording("K1"), recording("K2")
    try:
        render.render(scene, seed=0, device="cuda")
    finally:
        bk.intersect_brute, bk.occluded_brute = wrappers["K1"], wrappers["K2"]
    return seen


def _batch_phase(card):
    """Phase 20: K1 and K2 on the batches the banded loops hand them in
    one cbox sample of each render. Returns {render: {kernel: us}}."""
    import torch

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.integrators import render
    from gdpt_tpu_torch.scene import presets

    sums = {}
    for integrator in ("path", "gradpath"):
        batches = _record_brute_batches(
            render, bk, presets.cornell_box(512, 512, spp=1, integrator=integrator))
        per = sums.setdefault(integrator, {"K1": 0.0, "K2": 0.0})
        for j, (kind, args) in enumerate(batches):
            fn, plain = ((bk.intersect_brute, bk.intersect_brute_plain) if kind == "K1"
                         else (bk.occluded_brute, bk.occluded_brute_plain))
            label = f"{integrator} batch {j}"
            if kind == "K1":
                _compare_k1(fn(*args), plain(*args), label)
            else:
                _compare_k2(fn(*args), plain(*args), label, args[10] > args[11])
            ms, _ = _time_ms(lambda fn=fn, args=args: fn(*args), 10, 3)
            n_live, ops, nbytes = _brute_work(kind, args)
            n = args[10].shape[0]
            bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e6
            per[kind] += ms * 1e3
            print(f"phase 20: {label}: {kind} on {n} lanes, live {n_live / n:.4f}, "
                  f"{ms * 1e3:.2f} us by CUDA graph replay, bound {bound:.2f} us "
                  f"({ops / 1e9:.4f} Gop, {nbytes / 1e6:.2f} MB) on {card}")
        torch.cuda.synchronize()
        print(f"phase 20: cbox 512x512 {integrator}, one sample: {len(batches)} batches, each "
              f"equal to the plain version bit for bit; K1 {per['K1']:.1f} us + K2 "
              f"{per['K2']:.1f} us = {per['K1'] + per['K2']:.1f} us per sample on {card}")
    return sums


def _with_integrator(scene, integrator):
    import dataclasses

    st = scene.static
    return scene._replace(static=dataclasses.replace(
        st, options=dataclasses.replace(st.options, integrator=integrator)))


def _refracting(presets, bvh):
    """(center, radius) of the material box's refracting bodies: the
    rough dielectric, Disney glass and Disney BSDF spheres, and with bvh
    the two icosphere balls."""
    spheres = [presets.MATERIAL_SPHERES[i][:2] for i in (0, 3, 6)]
    return spheres + ([(c, r) for _, c, r in presets.ICOSPHERE_BALLS] if bvh else [])


def _inside(org, d, live, bodies):
    """Lanes whose ray starts on or just inside a refracting body and
    runs into it: a ray that the casts see from inside the geometry."""
    import torch

    from gdpt_tpu_torch.core import soa

    sel = torch.zeros_like(live)
    for center, radius in bodies:
        rel = org - soa.V3(*(float(c) for c in center))
        dist = soa.length(rel)
        sel |= (dist > 0.98 * radius) & (dist < 1.0001 * radius) & (soa.dot(d, rel) < 0)
    return sel & live


def _material_render(render, scene, phase, label, card, counters, spp=MAT_SPP, **walk):
    """One render of the material box on cuda, counters zeroed just
    before and read just after. Returns (image, aux or None, rays,
    launches, wall)."""
    import numpy as np

    grad = scene.static.options.integrator == "gradpath"
    for k in counters:
        counters[k] = 0
    t0 = time.perf_counter()
    out = render.render(scene, spp=spp, seed=0, device="cuda", return_stats=True,
                        return_aux=grad, **walk)
    wall = time.perf_counter() - t0
    launches = dict(counters)
    img, aux, rays = (out[0], out[1], out[2]) if grad else (out[0], None, out[1])
    means = (f"mean recon {float(img.mean()):.6f}, mean primal {float(aux['primal'].mean()):.6f}"
             if grad else f"mean radiance {float(img.mean()):.6f}")
    print(f"phase {phase}: material box {label} 512x512 spp {spp}: {means}, wall {wall:.3f} s, "
          f"rays {rays:.0f}, {rays / wall / 1e6:.2f} Mrays/s, launches {launches} on {card}")
    if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not float(img.mean()) > 0:
        raise AssertionError(f"material box {label}: image not finite, not 512x512x3 or black")
    if grad:
        if not all(np.isfinite(a).all() for a in aux.values()):
            raise AssertionError(f"material box {label}: auxiliary buffers not finite")
        m_recon, m_primal = float(img.mean()), float(aux["primal"].mean())
        if abs(m_recon - m_primal) > 0.02 * m_primal:
            raise AssertionError(f"material box {label}: the reconstruction lost the primal's mean")
    return img, aux, rays, launches, wall


def _material_phases(card):
    """Phases 21-23: the material box (every material kind, image
    textures, an image envmap) brute force and BVH, path and gradpath."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.core import soa
    from gdpt_tpu_torch.integrators import gdpt_soa, path_soa, render
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    dev = torch.device("cuda")

    # ---- phase 21: the brute-force material box, path and gradpath ----
    t_phase = t0 = time.perf_counter()
    box = presets.material_box(512, 512, MAT_SPP, max_depth=MAT_DEPTH, **MAT_IMAGES)
    path_soa.scene_soa_from_aos(scene_to(box, dev))
    st = box.static
    print(f"phase 21: material box: {st.n_tris} triangles, {st.n_spheres} spheres, material kinds "
          f"{st.used_material_kinds}, image envmap {st.envmap_is_image}, scene and tables "
          f"{time.perf_counter() - t0:.2f} s")
    if not st.use_brute_force or len(st.used_material_kinds) != 9 or not st.envmap_is_image:
        raise AssertionError("the brute-force material box is not the one asked for")
    for integrator in ("path", "gradpath"):
        _, _, _, launches, _ = _material_render(
            render, _with_integrator(box, integrator), 21, f"brute force {integrator}", card,
            bk.LAUNCHES)
        print(f"phase 21: K1 {launches['intersect'] / MAT_SPP:.1f} and K2 "
              f"{launches['occluded'] / MAT_SPP:.1f} launches per sample ({integrator})")
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel of the material box was never launched: {launches}")
    t_phase = _phase_done(21, t_phase)

    # ---- phase 22: cuda vs cpu at 32x32, brute force and BVH ----
    for bvh in (False, True):
        where = "BVH" if bvh else "brute force"
        small = presets.material_box(32, 32, 2, bvh=bvh,
                                     balls=MAT_SMALL_BALLS if bvh else None, **MAT_SMALL)
        if small.static.use_brute_force == bvh:
            raise AssertionError(f"the 32x32 {where} material box took the other regime")
        _cuda_vs_cpu(render, small, 22, f"material box path, {where}")
        _gradpath_cuda_vs_cpu(render, _with_integrator(small, "gradpath"),
                              f"material box, {where}", phase=22)
    t_phase = _phase_done(22, t_phase)

    # ---- phase 23: the BVH material box at full width ----
    t0 = time.perf_counter()
    bvh_box = presets.material_box(512, 512, MAT_SPP, bvh=True, max_depth=MAT_DEPTH,
                                   **MAT_IMAGES)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene_dev = scene_to(bvh_box, dev)
    sc = path_soa.scene_soa_from_aos(scene_dev)
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    st = bvh_box.static
    tab = sc.geom.packet
    n_tris = trs._table_n_tris(st)
    print(f"phase 23: BVH material box: {st.n_tris} triangles and {st.n_spheres} in-table "
          f"spheres by the {bvh_box.bvh_builder} builder, scene build {t_scene:.2f} s, packet "
          f"table {tab.table.shape[0]} rows, width {tab.width}, tables {t_table:.2f} s")
    if st.use_brute_force or st.n_tris < 400_000 or n_tris is None:
        raise AssertionError("the BVH material box is not the full-size one with in-table spheres")
    _, _, _, launches, _ = _material_render(render, bvh_box, 23, "BVH path", card, pk.LAUNCHES)
    print(f"phase 23: K3 launches per path sample: {launches['packet_intersect'] / MAT_SPP:.1f} "
          f"closest, {launches['packet_occluded'] / MAT_SPP:.1f} any hit; "
          f"{path_soa.render_soa_wavefront.last_iters} wavefront iterations, mean occupancy "
          f"{path_soa.render_soa_wavefront.last_occupancy:.3f}")
    if min(launches["packet_intersect"], launches["packet_occluded"]) == 0:
        raise AssertionError(f"a K3 mode of the BVH material box was never launched: {launches}")
    grad = _with_integrator(bvh_box, "gradpath")
    if path_soa.scene_soa_from_aos(scene_to(grad, "cuda")).geom.packet is not tab:
        raise AssertionError("the BVH material box's tables were not kept for the render")
    _, _, _, launches, _ = _material_render(render, grad, 23, "BVH gradpath", card, pk.LAUNCHES)
    iters = gdpt_soa._gdpt_wavefront_accum.last_iters
    print(f"phase 23: K3 launches per gradpath sample: {launches['packet_intersect'] / MAT_SPP:.1f} "
          f"closest, {launches['packet_occluded'] / MAT_SPP:.1f} any hit; {iters} wavefront "
          f"iterations, mean occupancy {gdpt_soa._gdpt_wavefront_accum.last_occupancy:.3f}")
    if min(launches["packet_intersect"], launches["packet_occluded"]) == 0 or \
            launches["packet_dual_intersect"] + launches["packet_dual_occluded"]:
        raise AssertionError(f"the BVH material box's gradpath did not go through K3: {launches}")
    t0 = time.perf_counter()
    tab16 = path_soa.scene_soa_from_aos(scene_dev, wide=16).geom.packet
    torch.cuda.synchronize()
    print(f"phase 23: 16-wide packet table {tab16.table.shape[0]} rows, tables "
          f"{time.perf_counter() - t0:.2f} s")
    outs = {}
    for dual in (False, True):
        outs[dual] = _material_render(render, grad, 23,
                                      f"BVH gradpath, 16-wide table, {'K4' if dual else 'K3'}",
                                      card, pk.LAUNCHES, spp=1, packet_wide=16, packet_dual=dual)
    (a, aux_a, ra, _, _), (b, aux_b, rb, launches, _) = outs[False], outs[True]
    if not (np.array_equal(a, b) and ra == rb
            and all(np.array_equal(aux_a[k], aux_b[k]) for k in aux_a)):
        raise AssertionError("the material box's K4 render differs from its K3 render")
    if min(launches["packet_dual_intersect"], launches["packet_dual_occluded"]) == 0 \
            or launches["packet_intersect"] + launches["packet_occluded"]:
        raise AssertionError(f"the dual render did not go through K4 alone: {launches}")
    print("phase 23: the material box's K4 render equals its K3 render on the 16-wide table")

    # Bounce rays that start inside the refracting balls, from the
    # render's own casts (a few wavefront iterations past the first).
    n_pix = st.width * st.height
    total = n_pix * MAT_SPP
    cam_arrays = scene_dev.device.camera
    state = path_soa._wavefront_state(n_pix, path_soa._pool_width(total), total, 1, dev)
    seen = []
    walk = pk.trace_packets

    def recording(table, *rays, **kw):
        if not kw.get("any_hit"):
            seen.append((rays, kw))
        return walk(table, *rays, **kw)

    pk.trace_packets = recording
    try:
        for _ in range(6):
            state = path_soa._wavefront_body(st, cam_arrays, sc, state)
    finally:
        pk.trace_packets = walk
    parts = []
    for rays, kw in seen[1:]:
        sel = _inside(soa.V3(*rays[:3]), soa.V3(*rays[3:6]), rays[7] >= rays[6],
                      _refracting(presets, True))
        parts.append(tuple(c[sel] for c in rays))
    inside = tuple(torch.cat(cs).contiguous() for cs in zip(*parts))
    n_in = inside[0].shape[0]
    if n_in < 1000:
        raise AssertionError(f"only {n_in} recorded rays start inside a refracting ball")
    _compare_k3(pk, tab, inside, n_tris, False, f"{n_in} bounce rays inside the refracting balls")
    ms, _ = _time_ms(lambda: pk.trace_packets(tab, *inside, n_tris=n_tris), 10, 3)
    ops, nbytes, n_read, visits = _walk_work(pk, tab, inside, False)
    print(f"phase 23: K3 closest on the {n_in} rays inside the refracting balls: "
          f"{ms * 1e3:.1f} us/launch by CUDA graph replay, bound "
          f"{max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e6:.2f} us ({ops / 1e9:.3f} "
          f"Gop, {nbytes / 1e6:.1f} MB, {n_read} rows read), {visits / n_in:.2f} visits per ray "
          f"on {card}")

    batches = _record_brute_batches(
        render, bk, presets.material_box(512, 512, 1, max_depth=MAT_DEPTH, **MAT_IMAGES))
    parts = []
    for kind, args in batches:
        if kind != "K1":
            continue
        org, d, tfar = soa.V3(*args[4:7]), soa.V3(*args[7:10]), args[10]
        sel = _inside(org, d, tfar > float(torch.tensor(args[11], dtype=torch.float32)),
                      _refracting(presets, False))
        parts.append((args, sel))
    args0 = parts[0][0]
    cut = tuple(torch.cat([a[i][sel] for a, sel in parts]).contiguous() for i in range(4, 11))
    n_in = cut[0].shape[0]
    if n_in < 1000:
        raise AssertionError(f"only {n_in} recorded K1 rays start inside a refracting sphere")
    k1_args = (*args0[:4], *cut, args0[11])
    _compare_k1(bk.intersect_brute(*k1_args), bk.intersect_brute_plain(*k1_args),
                f"{n_in} bounce rays inside the refracting spheres")
    ms, _ = _time_ms(lambda: bk.intersect_brute(*k1_args), 10, 3)
    _, ops, nbytes = _brute_work("K1", k1_args)
    print(f"phase 23: K1 on the {n_in} rays inside the refracting spheres: {ms * 1e3:.2f} us/launch "
          f"by CUDA graph replay, bound {max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e6:.2f}"
          f" us ({ops / 1e9:.4f} Gop, {nbytes / 1e6:.2f} MB) on {card}")

    # Path and gradpath wavefront iterations under the profiler: 4 and 2,
    # not a whole chunk each: the trace's read-back grows with every launch
    # recorded, and a gradpath chunk of this box is some 300,000 launches.
    for _ in range(2):  # steady state first
        state = path_soa._wavefront_body(st, cam_arrays, sc, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            state = path_soa._wavefront_body(st, cam_arrays, sc, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(prof, wall_us, 23, "4 path wavefront iterations of the BVH material box",
                    "packet_trace_kernel", "K3", card, iters=4)
    gst = grad.static
    used = gst.used_material_kinds
    gstate = gdpt_soa._gdpt_wavefront_state(gst, cam_arrays, sc, total, 1,
                                            path_soa._pool_width(total, 1 << 17))
    for _ in range(6):
        gstate = gdpt_soa._gdpt_wavefront_body(gst, cam_arrays, sc, used, gstate)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            gstate = gdpt_soa._gdpt_wavefront_body(gst, cam_arrays, sc, used, gstate)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(prof, wall_us, 23, "2 gradpath wavefront iterations of the BVH material box",
                    "packet_trace_kernel", "K3", card, iters=2)
    _phase_done(23, t_phase)


def _record_casts(trs, kernel_mod, kernel_name, want):
    """Context for a render: wraps traverse_soa.intersect_soa_gn to tag
    each cast "main" (tnear 0) or "shadow" with its index among the
    shadow casts since the last main cast, and the kernel wrapper
    `kernel_name` of `kernel_mod` to keep the arguments of the calls whose
    (tag, index, main casts so far) is in `want`: {key: args}."""
    import contextlib

    kept, state = {}, {"main": 0, "shadow": 0}
    cast, kernel = trs.intersect_soa_gn, getattr(kernel_mod, kernel_name)

    def tagging(static, g, org, d, tnear, *a, **kw):
        if tnear == 0.0:
            state["main"] += 1
            state["tag"] = ("main", 0, state["main"])
            state["shadow"] = 0
        else:
            state["tag"] = ("shadow", state["shadow"], state["main"])
            state["shadow"] += 1
        return cast(static, g, org, d, tnear, *a, **kw)

    def keeping(*args, **kw):
        if not kw.get("any_hit") and state.get("tag") in want:
            kept.setdefault(want[state["tag"]], (args, kw))
        return kernel(*args, **kw)

    @contextlib.contextmanager
    def ctx():
        trs.intersect_soa_gn = tagging
        setattr(kernel_mod, kernel_name, keeping)
        try:
            yield kept
        finally:
            trs.intersect_soa_gn = cast
            setattr(kernel_mod, kernel_name, kernel)

    return ctx()


def _volpath_render(render, scene, phase, label, card, counters, vol, **kw):
    """One volpath render on cuda, counts and host reads zeroed just
    before and read just after. Returns (image, rays, launches, reads,
    wall)."""
    import numpy as np

    for d in (counters, vol.HOST_READS):
        for k in d:
            d[k] = 0
    t0 = time.perf_counter()
    img, rays = render.render(scene, seed=0, device="cuda", return_stats=True, **kw)
    wall = time.perf_counter() - t0
    launches, reads = dict(counters), dict(vol.HOST_READS)
    spp = scene.static.options.samples_per_pixel
    print(f"phase {phase}: {label} 512x512 spp {spp}: mean radiance {float(img.mean()):.6f}, "
          f"wall {wall:.3f} s, rays {rays:.0f}, {rays / wall / 1e6:.3f} Mrays/s, launches "
          f"{launches}, host reads of loop conditions per sample "
          f"{ {k: v / spp for k, v in reads.items()} } on {card}")
    if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not float(img.mean()) > 0:
        raise AssertionError(f"{label}: image not finite, not 512x512x3 or black")
    return img, rays, launches, reads, wall


def _small_volpath(presets, **kw):
    """The 32x32, 2 spp, depth-6 grid scene of phase 25 (the grid
    scene of tests/test_torch_volpath.py)."""
    args = dict(version=6, width=32, height=32, spp=2, max_depth=6, g=0.6,
                with_diffuse_sphere=True, density=presets.medium_grid(16, 3, 0.8),
                albedo=presets.albedo_grid(16, 4))
    args.update(kw)
    return presets.volpath_scene(**args)


def _volpath_phases(card):
    """Phases 24-27: the volumetric integrator, brute force (K1) and BVH
    (K3). Returns the volpath launches per sample of K1 and K3."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.integrators import path_soa, render, volpath_soa
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    dev = torch.device("cuda")

    # ---- phase 24: the brute-force volumetric main path ----
    t_phase = time.perf_counter()
    scene = presets.volpath_scene(
        version=6, width=512, height=512, spp=VOL_SPP, g=0.6, with_diffuse_sphere=True,
        density=presets.medium_grid(VOL_GRID, 3, 0.8), albedo=presets.albedo_grid(VOL_GRID, 4))
    st = scene.static
    if not st.use_brute_force or st.media_grid_res != (((VOL_GRID,) * 3,) * 2,):
        raise AssertionError("the phase 24 scene is not the brute-force 64^3 grid scene")
    path_soa.scene_soa_from_aos(scene_to(scene, dev))
    with _record_casts(trs, bk, "intersect_brute",
                       {("main", 0, 3): "main", ("shadow", 0, 3): "shadow"}) as k1_batches:
        _, _, launches, reads, _ = _volpath_render(
            render, scene, 24, "brute-force volpath (grid medium)", card, bk.LAUNCHES,
            volpath_soa)
    k1_per_sample = launches["intersect"] / VOL_SPP
    print(f"phase 24: K1 {k1_per_sample:.1f} launches per sample, K2 "
          f"{launches['occluded']}; host reads per sample {sum(reads.values()) / VOL_SPP:.1f}")
    if not launches["intersect"] or launches["occluded"]:
        raise AssertionError(f"the volpath render did not go through K1 alone: {launches}")
    if set(k1_batches) != {"main", "shadow"}:
        raise AssertionError(f"phase 24 recorded {sorted(k1_batches)} of its K1 batches")
    t_phase = _phase_done(24, t_phase)

    # ---- phase 25: cuda vs cpu at 32x32 ----
    for label, small in (("grid, brute force", _small_volpath(presets)),
                         ("grid, force_bvh (no triangle)", _small_volpath(presets, force_bvh=True)),
                         ("null boundary", _small_volpath(
                             presets, density=presets.medium_grid(16, 3, 1.5),
                             albedo=np.array([0.9, 0.7, 0.8]), g=-0.4, null_boundary=True))):
        sst = small.static
        if "bvh" in label and (sst.use_brute_force or sst.n_tris):
            raise AssertionError("the force_bvh volpath scene is not the one without triangles")
        launches_before = dict(pk.LAUNCHES)
        a, ra = render.render(small, seed=3, device="cuda", return_stats=True)
        if "bvh" in label and pk.LAUNCHES["packet_intersect"] == launches_before["packet_intersect"]:
            raise AssertionError("the force_bvh volpath render did not launch K3")
        b, rb = render.render(small, seed=3, device="cpu", return_stats=True)
        _gate_cuda_vs_cpu(a, b, float(b.mean()), 25, f"volpath {label}")
        print(f"phase 25: rays cuda {ra:.0f}, cpu {rb:.0f}")
        if ra != rb:
            raise AssertionError(f"volpath {label}: cuda and cpu ray counts differ")
    t_phase = _phase_done(25, t_phase)

    # ---- phase 26: the BVH medium box at full width ----
    t0 = time.perf_counter()
    box = presets.medium_box(512, 512, VOL_BOX_SPP, grid_res=VOL_GRID)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene_dev = scene_to(box, dev)
    sc = path_soa.scene_soa_from_aos(scene_dev)
    torch.cuda.synchronize()
    st = box.static
    tab = sc.geom.packet
    n_tris = trs._table_n_tris(st)
    print(f"phase 26: medium box: {st.n_tris} triangles by the {box.bvh_builder} builder, scene "
          f"build {t_scene:.2f} s, packet table {tab.table.shape[0]} rows, width {tab.width}, "
          f"tables {time.perf_counter() - t0:.2f} s")
    if st.use_brute_force or st.n_tris < 400_000 or tab.width != 32:
        raise AssertionError("the medium box is not the full-size BVH scene")
    want = {("main", 0, 12): "main", ("shadow", 0, 12): "scatter", ("shadow", 1, 12): "crossing"}
    with _record_casts(trs, pk, "trace_packets", want) as k3_batches:
        _, _, launches, _, _ = _volpath_render(render, box, 26, "BVH medium box", card,
                                               pk.LAUNCHES, volpath_soa)
    acc = volpath_soa._vol_wavefront_accum
    k3_per_sample = launches["packet_intersect"] / VOL_BOX_SPP
    print(f"phase 26: K3 {k3_per_sample:.1f} closest launches per sample, any hit "
          f"{launches['packet_occluded']}; {acc.last_iters} wavefront iterations, mean "
          f"occupancy {acc.last_occupancy:.3f}")
    if not launches["packet_intersect"] or launches["packet_occluded"] or \
            launches["packet_dual_intersect"] + launches["packet_dual_occluded"]:
        raise AssertionError(f"the medium box did not go through K3 closest alone: {launches}")
    if set(k3_batches) != set(want.values()):
        raise AssertionError(f"phase 26 recorded {sorted(k3_batches)} of its K3 batches")
    lo = torch.tensor(presets.MEDIUM_BOX_MIN, device=dev)[:, None]
    hi = torch.tensor(presets.MEDIUM_BOX_MAX, device=dev)[:, None]
    for key in ("main", "scatter", "crossing"):
        (tab_b, *rays), kw = k3_batches[key]
        live = rays[7] >= rays[6]
        org = torch.stack(rays[:3])[:, live]
        inside = ((org > lo + 0.01) & (org < hi - 0.01)).all(dim=0).float().mean()
        on_face = (((org - lo).abs() < 0.01) | ((org - hi).abs() < 0.01)).any(dim=0)
        on_face = on_face.float().mean()
        print(f"phase 26: K3 {key} batch: {live.numel()} lanes, live {float(live.float().mean()):.4f}; "
              f"live origins strictly inside the medium box {float(inside):.4f}, on its faces "
              f"{float(on_face):.4f}")
        if key == "crossing" and not float(on_face) > 0.9:
            raise AssertionError("the recorded boundary-crossing batch does not start on the boundary")
        if key == "scatter" and not float(inside) > 0.5:
            raise AssertionError("the recorded scatter batch does not start inside the medium")
        _compare_k3(pk, tab_b, tuple(rays), kw.get("n_tris"), False, f"volpath {key} batch")
        ms, _ = _time_ms(lambda: pk.trace_packets(tab_b, *rays, n_tris=kw.get("n_tris")), 10, 3)
        ops, nbytes, n_read, visits = _walk_work(pk, tab_b, tuple(rays), False)
        n = rays[0].shape[0]
        print(f"phase 26: K3 closest on the volpath {key} batch: {ms * 1e3:.1f} us/launch by CUDA "
              f"graph replay, bound {max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e6:.2f}"
              f" us ({ops / 1e9:.3f} Gop, {nbytes / 1e6:.1f} MB, {n_read} rows read), "
              f"{visits / n:.2f} visits per ray on {card}")
    for key in ("main", "shadow"):
        args, _ = k1_batches[key]
        _compare_k1(bk.intersect_brute(*args), bk.intersect_brute_plain(*args),
                    f"volpath {key} batch")
        ms, _ = _time_ms(lambda: bk.intersect_brute(*args), 10, 3)
        n_live, ops, nbytes = _brute_work("K1", args)
        n = args[10].shape[0]
        print(f"phase 26: K1 on phase 24's {key} batch ({n} lanes, live {n_live / n:.4f}, tnear "
              f"{args[11]:g}): {ms * 1e3:.2f} us/launch by CUDA graph replay, bound "
              f"{max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e6:.2f} us "
              f"({ops / 1e9:.4f} Gop, {nbytes / 1e6:.2f} MB) on {card}")
    t_phase = _phase_done(26, t_phase)

    # ---- phase 27: two wavefront iterations under the profiler ----
    n_pix = st.width * st.height
    total = n_pix * VOL_BOX_SPP
    media = volpath_soa.meds.media_soa(scene_dev.device.media)
    cam = scene_dev.device.camera
    state = volpath_soa._vol_wavefront_state(st, cam, total, 1, path_soa._pool_width(total, 1 << 17))
    for _ in range(6):  # steady state first
        state = volpath_soa._vol_wavefront_body(st, cam, sc, media, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state = volpath_soa._vol_wavefront_body(st, cam, sc, media, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _report_profile(prof, wall_us, 27, "2 volpath wavefront iterations of the medium box",
                    "packet_trace_kernel", "K3", card, iters=2)
    _phase_done(27, t_phase)
    return k1_per_sample, k3_per_sample


def _cli(cli, argv, phase, card):
    """cli.main(argv) in this process, its report lines printed under the
    phase's name; returns its [(scene, image)]."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    for line in buf.getvalue().splitlines():
        print(f"phase {phase}: cli: {line} ({card})")
    return out


@contextlib.contextmanager
def _timed_calls(mod, name):
    """Wraps mod.name so that each call's wall seconds are appended to the
    list it yields."""
    times, fn = [], getattr(mod, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            times.append(time.perf_counter() - t0)

    setattr(mod, name, timed)
    try:
        yield times
    finally:
        setattr(mod, name, fn)


@contextlib.contextmanager
def _keep_gradpath_sums(gdpt_soa):
    """Keeps the (6, 3, n) sample sums and spp that the gradient-domain
    render hands its Poisson solve (gdpt_soa._gdpt_finish)."""
    kept, finish = {}, gdpt_soa._gdpt_finish

    def keeping(static, acc, spp, *a, **kw):
        kept["acc"], kept["spp"] = acc.copy(), spp
        return finish(static, acc, spp, *a, **kw)

    gdpt_soa._gdpt_finish = keeping
    try:
        yield kept
    finally:
        gdpt_soa._gdpt_finish = finish


def _resume_on(renderer, scene, spp, ckpt, checkpoint, device, **kw):
    """(resumed image, uninterrupted image): the first spp // 2 samples
    rendered with an on_chunk that saves under the full render's
    fingerprint (the state a render stopped part way leaves), then
    resumed to spp by render_with_checkpoints; the uninterrupted render
    takes the same (banded) route."""
    from gdpt_tpu_torch.scene.build import scene_to

    fp = checkpoint._fingerprint(scene, spp, 0)
    kept = {}
    renderer(scene_to(scene, device), spp=spp // 2, seed=0,
             on_chunk=lambda acc, done: kept.update(acc=acc.copy(), done=done))
    checkpoint.save_checkpoint(ckpt, kept["acc"], kept["done"], fp)
    resumed = checkpoint.render_with_checkpoints(scene, spp=spp, seed=0, every=1, path=ckpt,
                                                 device=device)
    return resumed, renderer(scene_to(scene, device), spp=spp, seed=0, wavefront=False, **kw)


def _file_phases(card):
    """Phases 28-31: the command-line entry point: scene files written
    here and parsed by the port, the AOV integrators, checkpoint and
    resume."""
    import functools
    import os
    import tempfile
    import types
    import warnings

    import numpy as np
    import torch

    from gdpt_tpu_torch import cli
    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import bvh
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.core import image as gimage
    from gdpt_tpu_torch.core import transform as xf
    from gdpt_tpu_torch.integrators import aux, gdpt_soa, path_soa, render, volpath_soa
    from gdpt_tpu_torch.scene import loaders, parser, presets, xml_writer
    from gdpt_tpu_torch.scene import model as M
    from gdpt_tpu_torch.scene.build import scene_to
    from gdpt_tpu_torch.utils import checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 28: the brute-force scene file through the command line ----
        t_phase = time.perf_counter()
        cbox_xml = xml_writer.write_scene(os.path.join(tmp, "cbox"), **presets.cornell_box_parts(
            512, 512, FILE_SPP, "path", -1))
        sub_exr = os.path.join(tmp, "cbox_sub.exr")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "gdpt_tpu_torch", cbox_xml, "-o", sub_exr,
                               "--spp", str(FILE_SPP), "--device", "cuda"], cwd=root,
                              capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            print(f"phase 28: python -m gdpt_tpu_torch: {line}")
        print(f"phase 28: the command took {time.perf_counter() - t0:.2f} s, exit "
              f"{proc.returncode} ({card})")
        if proc.returncode != 0:
            raise AssertionError(f"python -m gdpt_tpu_torch failed:\n{proc.stderr}")
        img = gimage.read_exr(sub_exr)
        if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not img.mean() > 0:
            raise AssertionError("the command's EXR is not finite, not 512x512x3 or black")
        for k in bk.LAUNCHES:
            bk.LAUNCHES[k] = 0
        [(cbox, cbox_img)] = _cli(cli, [cbox_xml, "-o", os.path.join(tmp, "cbox.exr"),
                                        "--device", "cuda"], 28, card)
        launches = dict(bk.LAUNCHES)
        print(f"phase 28: in process: mean radiance {float(cbox_img.mean()):.6f} (the command's "
              f"EXR {float(img.mean()):.6f}), launches {launches}")
        if min(launches.values()) == 0:
            raise AssertionError(f"the scene file's render did not launch K1 and K2: {launches}")
        if not np.array_equal(gimage.read_exr(os.path.join(tmp, "cbox.exr")), cbox_img):
            raise AssertionError("the EXR written does not hold the rendered image")
        t_phase = _phase_done(28, t_phase)

        # ---- phase 29: the BVH scene file (binary PLY) through the command line ----
        ico_xml = xml_writer.write_scene(os.path.join(tmp, "ico"), **presets.icosphere_box_parts(
            512, 512, FILE_SPP, integrator="gradpath"))
        print(f"phase 29: wrote the icosphere box: "
              f"{sum(os.path.getsize(os.path.join(tmp, 'ico', f)) for f in os.listdir(os.path.join(tmp, 'ico'))) / 1e6:.1f}"
              f" MB of XML and binary PLY")
        for k in pk.LAUNCHES:
            pk.LAUNCHES[k] = 0
        with _keep_gradpath_sums(gdpt_soa) as sums, \
                _timed_calls(loaders, "load_ply") as t_ply, _timed_calls(bvh, "build_bvh") as t_bvh:
            [(ico, recon)] = _cli(cli, [ico_xml, "-o", os.path.join(tmp, "ico.exr"),
                                        "--device", "cuda"], 29, card)
        launches = dict(pk.LAUNCHES)
        print(f"phase 29: of the parse, the PLY reader (loaders.load_ply, {len(t_ply)} call) took "
              f"{sum(t_ply):.3f} s and the BVH build (bvh.build_bvh, {len(t_bvh)} call) "
              f"{sum(t_bvh):.3f} s on the card's host")
        st = ico.static
        m_recon, m_primal = float(recon.mean()), float((sums["acc"][0] / sums["spp"]).mean())
        print(f"phase 29: {st.n_tris} triangles ({ico.bvh_builder} BVH), gradpath spp "
              f"{sums['spp']}: mean recon {m_recon:.6f}, mean primal {m_primal:.6f}, "
              f"launches {launches}, {gdpt_soa._gdpt_wavefront_accum.last_iters} wavefront "
              f"iterations")
        if st.use_brute_force or st.n_tris != 409_612 or sums["spp"] != FILE_SPP:
            raise AssertionError("the parsed file is not the 409,612-triangle BVH scene at its spp")
        if recon.shape != (512, 512, 3) or not np.isfinite(recon).all() or not m_primal > 0:
            raise AssertionError("the file's gradpath image is not finite, not 512x512x3 or black")
        if abs(m_recon - m_primal) > 0.02 * m_primal:
            raise AssertionError("the reconstruction lost the primal's mean (the DC term)")
        if min(launches["packet_intersect"], launches["packet_occluded"]) == 0:
            raise AssertionError(f"the BVH file's render did not launch K3: {launches}")
        t_phase = _phase_done(29, t_phase)

        # ---- phase 30: the AOV integrators ----
        for label, scene, counter, key in (("cbox file", cbox, bk.LAUNCHES, "intersect"),
                                           ("icosphere box file", ico, pk.LAUNCHES,
                                            "packet_intersect")):
            for kind in aux.AUX_KINDS:
                counter[key] = 0
                t0 = time.perf_counter()
                img = render.render(_with_integrator(scene, kind), device="cuda")
                wall = time.perf_counter() - t0
                print(f"phase 30: {label} {kind} 512x512: wall {wall * 1e3:.1f} ms, mean "
                      f"{float(img.mean()):.6g}, {key} launches {counter[key]} on {card}")
                if img.shape != (512, 512, 3) or not np.isfinite(img).all():
                    raise AssertionError(f"{label} {kind}: not finite or not 512x512x3")
                if counter[key] != 1:
                    raise AssertionError(f"{label} {kind}: {counter[key]} {key} launches, not one")
                if kind in ("depth", "shading_normal", "ray_differential") and \
                        not np.abs(img).max() > 0:
                    raise AssertionError(f"{label} {kind} is zero everywhere")
        mat = presets.material_box(512, 512, 1)
        t0 = time.perf_counter()
        img = render.render(_with_integrator(mat, "mipmap_level"), device="cuda")
        print(f"phase 30: material box mipmap_level 512x512: wall "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, levels {float(img.min()):.3f} to "
              f"{float(img.max()):.3f}, non-zero share {float((img != 0).mean()):.4f} on {card}")
        if not np.isfinite(img).all() or not (img != 0).any():
            raise AssertionError("the material box's mip levels are zero everywhere")
        for kind in aux.AUX_KINDS:
            for bvh in (False, True):
                small = presets.cornell_box(32, 32, integrator=kind, force_bvh=bvh)
                a = render.render(small, device="cuda")
                b = render.render(small, device="cpu")
                _gate_cuda_vs_cpu(a, b, float(np.abs(b).mean()), 30,
                                  f"{kind}, {'BVH' if bvh else 'brute force'}")
        golden = gimage.read_exr(os.path.join(root, "tests", "goldens", "cbox_depth.exr"))
        img = render.render(presets.cornell_box(64, 64, integrator="depth"), device="cuda")
        rel = float(np.sqrt(((img - golden) ** 2).mean())) / max(float(np.abs(golden).mean()), 1e-3)
        print(f"phase 30: cbox_depth golden on cuda: RMSE / mean {rel:.3g} (bound 0.05)")
        if not rel < 0.05:
            raise AssertionError("the cbox_depth golden fails on the card")
        t_phase = _phase_done(30, t_phase)

        # ---- phase 31: checkpoint and resume on the card ----
        vol_xml = presets.build_volpath_scene(
            M, types.SimpleNamespace(build_scene=functools.partial(
                xml_writer.write_scene, os.path.join(tmp, "vol"))), xf,
            version=6, width=512, height=512, spp=FILE_VOL_SPP, g=0.6, with_diffuse_sphere=True,
            density=presets.medium_grid(VOL_GRID, 3, 0.8), albedo=presets.albedo_grid(VOL_GRID, 4))
        vol, _ = parser.parse_scene(vol_xml)
        if vol.static.media_grid_res != (((VOL_GRID,) * 3,) * 2,) or not vol.static.use_brute_force:
            raise AssertionError("the volpath file is not the brute-force 64^3 grid scene")
        for label, renderer, scene, spp in (
                ("path, icosphere box file (banded)", path_soa.render_soa,
                 _with_integrator(ico, "path"), FILE_RESUME_SPP),
                ("gradpath, cbox file", gdpt_soa.render_gradpath_soa,
                 _with_integrator(cbox, "gradpath"), FILE_RESUME_SPP),
                ("volpath, grid file", volpath_soa.render_volpath_soa, vol, FILE_VOL_SPP)):
            t0 = time.perf_counter()
            resumed, straight = _resume_on(renderer, scene, spp, os.path.join(tmp, "r.ckpt.npz"),
                                           checkpoint, "cuda")
            diff = float(np.abs(resumed - straight).max())
            exact = bool(np.array_equal(resumed, straight))
            print(f"phase 31: {label}, {spp // 2} + {spp - spp // 2} of {spp} spp resumed: "
                  f"{'equal bit for bit' if exact else 'not bit for bit'} to the uninterrupted "
                  f"render, largest difference {diff:.3g}, mean {float(straight.mean()):.6f}; "
                  f"{time.perf_counter() - t0:.1f} s on {card}")
            if label.startswith("path") and not exact:
                raise AssertionError("a resume over the same passes is not bit for bit")
            if not exact:
                _gate_cuda_vs_cpu(resumed, straight, float(straight.mean()), 31, label,
                                  "resumed vs uninterrupted 512x512")
        small, _ = parser.parse_scene(cbox_xml, width=32, height=32, spp=2)
        ckpt = os.path.join(tmp, "small.ckpt.npz")
        fp_cuda = checkpoint._fingerprint(scene_to(small, "cuda"), 2, 0)
        fp_cpu = checkpoint._fingerprint(small, 2, 0)
        kept = {}
        path_soa.render_soa(scene_to(small, "cuda"), spp=1, seed=0,
                            on_chunk=lambda acc, done: kept.update(acc=acc.copy(), done=done))
        checkpoint.save_checkpoint(ckpt, kept["acc"], kept["done"], fp_cuda)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a discarded checkpoint warns: fail on it
            resumed = checkpoint.render_with_checkpoints(small, spp=2, seed=0, path=ckpt,
                                                         device="cpu")
        straight = render.render(small, spp=2, seed=0, device="cpu")
        print(f"phase 31: a 32x32 checkpoint written on cuda resumes on the CPU: fingerprints "
              f"{'equal' if fp_cuda == fp_cpu else 'differ'}, largest difference "
              f"{float(np.abs(resumed - straight).max()):.3g}")
        if fp_cuda != fp_cpu:
            raise AssertionError("the fingerprint depends on the device")
        _gate_cuda_vs_cpu(resumed, straight, float(straight.mean()), 31, "cbox path",
                          "resumed from cuda vs uninterrupted on cpu 32x32")
        torch.cuda.synchronize()
        _phase_done(31, t_phase)

@contextlib.contextmanager
def _keep_calls(mod, name, pick):
    """Wraps mod.name; keeps (args, kw) of the first call for each label
    that pick(args, kw) returns (None: not kept). Yields {label: (args, kw)}."""
    kept, fn = {}, getattr(mod, name)

    def keeping(*args, **kw):
        label = pick(args, kw)
        if label is not None:
            kept.setdefault(label, (args, kw))
        return fn(*args, **kw)

    setattr(mod, name, keeping)
    try:
        yield kept
    finally:
        setattr(mod, name, fn)


def _profiled_bounces(vp, prof, first, count, out):
    """Context: the per-ray rungs' bounce loop runs `prof` from the start
    of bounce body `first` to the start of body `first + count` (or the
    loop's end): `count` whole iterations, their nested shadow loops and
    masked updates included. out gets the window's wall (us) and the
    number of iterations it held."""
    loop = vp._masked_loop

    def profiled(cond, body, state, name):
        if name != "bounce":
            return loop(cond, body, state, name)
        seen = [0]

        def timed(s, live):
            import torch

            seen[0] += 1
            if seen[0] == first:
                torch.cuda.synchronize()
                prof.start()
                out["t0"] = time.perf_counter()
            elif seen[0] == first + count:
                _stop(torch)
            return body(s, live)

        def _stop(torch):
            torch.cuda.synchronize()
            out["wall_us"] = (time.perf_counter() - out.pop("t0")) * 1e6
            out["iters"] = seen[0] - first
            prof.stop()

        result = loop(cond, timed, state, name)
        if "t0" in out:
            import torch

            seen[0] += 1
            _stop(torch)
        return result

    @contextlib.contextmanager
    def ctx():
        vp._masked_loop = profiled
        try:
            yield
        finally:
            vp._masked_loop = loop

    return ctx()


def _rng_launches(rng, n, dev):
    """Kernel launches of one rng.uniform draw of each shape on n lanes,
    counted under the profiler: {(): k, (2,): k}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    key = rng.ray_key(rng.prng_key(0, n, dev), torch.arange(n, device=dev))
    b = torch.ones(n, dtype=torch.int32, device=dev)
    out = {}
    for shape in ((), (2,)):
        rng.uniform(key, b, rng.SLOT_RR, shape)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rng.uniform(key, b, rng.SLOT_RR, shape)
            torch.cuda.synchronize()
        out[shape] = sum(e.count for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
    return out


def _time_batch(kind, fn, work, phase, label, card):
    """Times one recorded batch by CUDA graph replay; returns (ms, bound ms)."""
    ms, _ = _time_ms(fn, 10, 3)
    ops, nbytes = work
    bound = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S) * 1e3
    print(f"phase {phase}: {kind} on the {label}: {ms * 1e3:.2f} us/launch by CUDA graph replay, "
          f"bound {bound * 1e3:.2f} us ({ops / 1e9:.4f} Gop, {nbytes / 1e6:.2f} MB) on {card}")
    return ms, bound


def _rung_phases(card):
    """Phases 32-35: the per-ray volpath rungs (versions 1-5) through
    render_samples on K1, K2 and K3. Returns {kernel: {batch: (launches
    per sample, ms, bound ms)}} for the kernels line."""
    import functools
    import os
    import tempfile
    import types

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.core import image as gimage
    from gdpt_tpu_torch.core import rng
    from gdpt_tpu_torch.core import transform as xf
    from gdpt_tpu_torch.integrators import path_soa, render
    from gdpt_tpu_torch.integrators import volpath as vp
    from gdpt_tpu_torch.scene import model as M
    from gdpt_tpu_torch.scene import parser, presets, xml_writer
    from gdpt_tpu_torch.scene.build import scene_to
    from gdpt_tpu_torch.utils import checkpoint

    dev = torch.device("cuda")
    rows = {"K1": {}, "K2": {}, "K3 closest": {}, "K3 any hit": {}}

    # ---- phase 32: the rungs at 512x512, brute force ----
    t_phase = time.perf_counter()
    want = {("main", 0, 3): "v5 bounce cast", ("shadow", 1, 3): "v5 shadow segment"}
    k1_batches, k2_batches = {}, {}
    for ver in (1, 2, 3, 4, 5):
        scene = presets.volpath_scene(version=ver, width=512, height=512, spp=RUNG_SPP,
                                      max_depth=-1, with_diffuse_sphere=(ver == 5))
        if not scene.static.use_brute_force:
            raise AssertionError("the phase 32 scene is not brute force")
        path_soa.scene_soa_from_aos(scene_to(scene, dev))
        record = _record_casts(trs, bk, "intersect_brute", want if ver == 5 else {})
        shadow = _keep_calls(bk, "occluded_brute",
                             lambda a, kw: "v2 shadow ray" if ver == 2 else None)
        for d in (bk.LAUNCHES, vp.HOST_READS):
            for k in d:
                d[k] = 0
        with record as k1_kept, shadow as k2_kept:
            t0 = time.perf_counter()
            img, rays = render.render(scene, seed=0, device="cuda", return_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches, reads = dict(bk.LAUNCHES), dict(vp.HOST_READS)
        k1_batches.update(k1_kept)
        k2_batches.update({k: v[0] for k, v in k2_kept.items()})
        per = {k: v / RUNG_SPP for k, v in launches.items()}
        print(f"phase 32: volpath v{ver} 512x512 spp {RUNG_SPP}: mean radiance "
              f"{float(img.mean()):.6f}, wall {wall:.3f} s, rays {rays:.0f}, "
              f"{rays / wall / 1e6:.3f} Mrays/s, K1 {per['intersect']:.2f} and K2 "
              f"{per['occluded']:.2f} launches per sample, host reads per sample "
              f"{ {k: v / RUNG_SPP for k, v in reads.items()} } on {card}")
        if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not float(img.mean()) > 0:
            raise AssertionError(f"v{ver}: image not finite, not 512x512x3 or black")
        if not launches["intersect"] or bool(launches["occluded"]) != (ver == 2):
            raise AssertionError(f"v{ver} did not go through K1 (and K2 for v2 only): {launches}")
        rows["K1"][f"v{ver} per sample"] = per["intersect"]
        if ver == 2:
            rows["K2"]["v2 per sample"] = per["occluded"]
    if set(k1_batches) != set(want.values()) or len(k2_batches) != 1:
        raise AssertionError(f"phase 32 kept {sorted(k1_batches)} and {sorted(k2_batches)}")
    t_phase = _phase_done(32, t_phase)

    # ---- phase 33: cuda vs cpu at 32x32 ----
    small = [(f"v{ver}", presets.volpath_scene(version=ver, width=32, height=32, spp=2,
                                               max_depth=6, with_diffuse_sphere=(ver == 5)))
             for ver in (1, 2, 3, 4, 5)]
    balls = [(1, (368.0, 100.0, 351.0), 100.0), (1, (186.0, 60.0, 169.0), 60.0)]
    for ver in (5, 2):
        small.append((f"medium box v{ver} (BVH)", presets.medium_box(
            32, 32, 2, balls=balls, grid_res=16, max_depth=6, version=ver)))
    for label, sc in small:
        before = dict(pk.LAUNCHES)
        a, ra = render.render(sc, seed=3, device="cuda", return_stats=True)
        if "BVH" in label:
            mode = "packet_occluded" if label.endswith("v2 (BVH)") else "packet_intersect"
            if sc.static.use_brute_force or pk.LAUNCHES[mode] == before[mode]:
                raise AssertionError(f"{label} did not go through the packet walk K3 ({mode})")
        b, rb = render.render(sc, seed=3, device="cpu", return_stats=True)
        _gate_cuda_vs_cpu(a, b, float(b.mean()), 33, f"volpath {label}")
        print(f"phase 33: rays cuda {ra:.0f}, cpu {rb:.0f}")
        if ra != rb:
            raise AssertionError(f"volpath {label}: cuda and cpu ray counts differ")
    t_phase = _phase_done(33, t_phase)

    # ---- phase 34: K1, K2, K3 on the rungs' own batches; two v5 bounces profiled ----
    args = k2_batches["v2 shadow ray"]
    live = args[10] > float(torch.tensor(args[11], dtype=torch.float32))
    _compare_k2(bk.occluded_brute(*args), bk.occluded_brute_plain(*args), "v2 shadow ray", live)
    n_live, ops, nbytes = _brute_work("K2", args)
    rows["K2"]["v2 shadow ray"] = _time_batch(
        "K2", lambda: bk.occluded_brute(*args), (ops, nbytes), 34,
        f"v2 shadow ray batch ({args[10].shape[0]} lanes, live {n_live / args[10].shape[0]:.4f})",
        card)
    for key in ("v5 bounce cast", "v5 shadow segment"):
        kargs, _ = k1_batches[key]
        _compare_k1(bk.intersect_brute(*kargs), bk.intersect_brute_plain(*kargs), key)
        n_live, ops, nbytes = _brute_work("K1", kargs)
        n = kargs[10].shape[0]
        rows["K1"][key] = _time_batch(
            "K1", lambda: bk.intersect_brute(*kargs), (ops, nbytes), 34,
            f"{key} batch ({n} lanes, live {n_live / n:.4f}, tnear {kargs[11]:g})", card)

    box = presets.medium_box(512, 512, 1, grid_res=VOL_GRID, max_depth=RUNG_BOX_DEPTH,
                             version=5)
    if box.static.use_brute_force or box.static.n_tris < 400_000:
        raise AssertionError("the medium box is not the full-size BVH scene")
    tab = path_soa.scene_soa_from_aos(scene_to(box, dev)).geom.packet
    want = {("main", 0, 2): "v5 bounce cast", ("shadow", 0, 2): "v5 shadow segment"}
    for k in pk.LAUNCHES:
        pk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with _record_casts(trs, pk, "trace_packets", want) as k3_batches:
        img, rays = render.render(box, seed=0, device="cuda", return_stats=True)
    wall = time.perf_counter() - t0
    launches = dict(pk.LAUNCHES)
    print(f"phase 34: medium box v5 512x512 1 spp depth {RUNG_BOX_DEPTH} on the {tab.width}-wide "
          f"table: wall {wall:.3f} s, rays {rays:.0f}, {rays / wall / 1e6:.3f} Mrays/s, "
          f"launches {launches}, mean {float(img.mean()):.6f} on {card}")
    if not launches["packet_intersect"] or launches["packet_occluded"] or tab.width != 32:
        raise AssertionError(f"the v5 medium box did not go through K3 closest: {launches}")
    if not np.isfinite(img).all() or not float(img.mean()) > 0:
        raise AssertionError("the v5 medium box image is not finite or black")
    rows["K3 closest"]["medium box v5 per sample"] = launches["packet_intersect"]
    box2 = presets.medium_box(512, 512, 1, grid_res=VOL_GRID, version=2)
    with _keep_calls(pk, "trace_packets",
                     lambda a, kw: "v2 shadow ray" if kw.get("any_hit") else None) as any_kept:
        render.render(box2, seed=0, device="cuda")
    k3_batches.update(any_kept)
    for key, any_hit in (("v5 bounce cast", False), ("v5 shadow segment", False),
                         ("v2 shadow ray", True)):
        (tab_b, *r), kw = k3_batches[key]
        n_tris = kw.get("n_tris")
        _compare_k3(pk, tab_b, tuple(r), n_tris, any_hit, f"medium box {key}")
        ops, nbytes, _, visits = _walk_work(pk, tab_b, tuple(r), any_hit)
        n = r[0].shape[0]
        row = "K3 any hit" if any_hit else "K3 closest"
        rows[row][f"medium box {key}"] = _time_batch(
            row, lambda: pk.trace_packets(tab_b, *r, n_tris=n_tris, any_hit=any_hit),
            (ops, nbytes), 34, f"medium box {key} batch ({n} lanes, live "
            f"{float((r[7] > r[6]).float().mean()):.4f}, {visits / n:.2f} visits per ray)", card)

    scene = presets.volpath_scene(version=5, width=512, height=512, spp=RUNG_SPP, max_depth=-1,
                                  with_diffuse_sphere=True)
    per_draw = _rng_launches(rng, 512 * 512 * RUNG_SPP, dev)
    draws = {(): 0, (2,): 0}
    uniform, window = rng.uniform, {}

    def counting(key, bounce, slot, shape=()):
        if "t0" in window:  # only the draws of the profiled window
            draws[tuple(shape)] += 1
        return uniform(key, bounce, slot, shape)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rng.uniform = counting
    try:
        with _profiled_bounces(vp, prof, 3, 2, window):
            render.render(scene, seed=0, device="cuda")
    finally:
        rng.uniform = uniform
    iters = window.get("iters", 0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    count = sum(e.count for e in kernels)
    busy = sum(getattr(e, "self_device_time_total", 0) for e in kernels)
    if iters != 2 or not count:
        raise AssertionError(f"the profiled window held {iters} bounces and {count} launches")
    n_rng = draws[()] * per_draw[()] + draws[(2,)] * per_draw[(2,)]
    print(f"phase 34: two v5 bounce iterations (bodies 3 and 4, {512 * 512 * RUNG_SPP} lanes) "
          f"under torch.profiler on {card}: wall {window['wall_us'] / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({busy / window['wall_us']:.3f} of wall), {count / iters:.0f} "
          f"kernel launches per iteration; RNG draws {draws} at {per_draw[()]} (scalar) and "
          f"{per_draw[(2,)]} (pair) launches each: {n_rng / iters:.0f} launches per iteration, "
          f"{n_rng / count:.3f} of launches")
    for e in sorted(kernels, key=lambda e: -getattr(e, "self_device_time_total", 0))[:6]:
        print(f"  {getattr(e, 'self_device_time_total', 0) / 1e3:8.2f} ms  {e.count:6d}x  "
              f"{e.key[:80]}")
    t_phase = _phase_done(34, t_phase)

    # ---- phase 35: the golden, the command line and resume ----
    root = os.path.dirname(os.path.abspath(__file__))
    golden = gimage.read_exr(os.path.join(root, "tests", "goldens", "volpath_v5.exr"))
    img = render.render(presets.volpath_scene(version=5, width=32, height=32, spp=32,
                                              max_depth=5, with_diffuse_sphere=True),
                        seed=42, device="cuda")
    rel = float(np.sqrt(((img - golden) ** 2).mean())) / max(float(np.abs(golden).mean()), 1e-3)
    print(f"phase 35: volpath_v5 golden on cuda: RMSE / mean {rel:.3g} (bound 0.05)")
    if not rel < 0.05:
        raise AssertionError("the volpath_v5 golden fails on the card")
    with tempfile.TemporaryDirectory() as tmp:
        xml = presets.build_volpath_scene(
            M, types.SimpleNamespace(build_scene=functools.partial(
                xml_writer.write_scene, os.path.join(tmp, "v5"))), xf,
            version=5, width=512, height=512, with_diffuse_sphere=True, g=0.5, **RUNG_FILE)
        exr = os.path.join(tmp, "v5.exr")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "gdpt_tpu_torch", xml, "-o", exr,
                               "--device", "cuda"], cwd=root, capture_output=True, text=True,
                              timeout=600)
        for line in proc.stdout.splitlines():
            print(f"phase 35: python -m gdpt_tpu_torch: {line}")
        print(f"phase 35: the command took {time.perf_counter() - t0:.2f} s, exit "
              f"{proc.returncode} ({card})")
        if proc.returncode != 0:
            raise AssertionError(f"python -m gdpt_tpu_torch failed on the v5 file:\n{proc.stderr}")
        straight = gimage.read_exr(exr)
        if straight.shape != (512, 512, 3) or not np.isfinite(straight).all() or \
                not straight.mean() > 0:
            raise AssertionError("the v5 file's EXR is not finite, not 512x512x3 or black")
        v5, _ = parser.parse_scene(xml)
        spp = v5.static.options.samples_per_pixel
        ckpt = os.path.join(tmp, "v5.ckpt.npz")
        fp = checkpoint._fingerprint(v5, spp, 0)

        class Stop(Exception):
            pass

        def first_pass(acc, done):
            checkpoint.save_checkpoint(ckpt, acc, done, fp)
            raise Stop(done)

        t0 = time.perf_counter()
        try:
            render.render_samples(scene_to(v5, dev), vp.trace_fn(v5.static), seed=0,
                                  on_chunk=first_pass)
            raise AssertionError("the v5 file rendered in one pass: nothing to resume")
        except Stop as stop:
            done = stop.args[0]
        if not 0 < done < spp:
            raise AssertionError(f"the v5 file's first pass took {done} of {spp} spp")
        resumed = checkpoint.render_with_checkpoints(v5, seed=0, every=1, path=ckpt,
                                                     device="cuda")
        exact = bool(np.array_equal(resumed, straight))
        print(f"phase 35: v5 file, {done} + {spp - done} of {spp} spp resumed: "
              f"{'equal bit for bit' if exact else 'not bit for bit'} to the command's "
              f"uninterrupted render, largest difference "
              f"{float(np.abs(resumed - straight).max()):.3g}; "
              f"{time.perf_counter() - t0:.1f} s on {card}")
        if not exact:
            raise AssertionError("the resumed v5 render differs from the uninterrupted one")
    _phase_done(35, t_phase)
    return rows

def _nth(want, kind_of=lambda a, kw: None):
    """A _keep_calls picker: counts the calls of each kind_of(args, kw)
    and labels the n-th of a kind as want[(kind, n)] says."""
    seen = {}

    def pick(a, kw):
        kind = kind_of(a, kw)
        seen[kind] = seen.get(kind, 0) + 1
        return want.get((kind, seen[kind]))

    return pick


def _perray_phases(card, ctx):
    """Phases 36-39: the per-ray oracles (integrators/path.py,
    gdpt.render_gradpath, volpath.trace_volpath_final) at 512x512 through
    K1, K2 and K3, and their cross-checks. Returns {kernel: {entry:
    launches per sample, or (ms, bound ms) of a batch}} for the kernels
    line."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.core import image as gimage
    from gdpt_tpu_torch.integrators import gdpt, path, path_soa, render
    from gdpt_tpu_torch.integrators import volpath as vp
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    dev = torch.device("cuda")
    rows = {"K1": {}, "K2": {}, "K3 closest": {}, "K3 any hit": {}}
    k1_kept, k2_kept, k3_kept = {}, {}, {}
    lanes = lambda a, kw: a[10].shape[0]  # noqa: E731 (a K1 call's lane count)
    walk = lambda a, kw: (bool(kw.get("any_hit")), a[1].shape[0])  # noqa: E731

    def run(phase, label, scene, fn, spp, need, keep=()):
        """fn() with every count and host read zeroed just before and read
        just after; keep: (module, wrapper, picker, dict) whose calls are
        kept. Returns (fn's result, wall, launches and host reads per
        sample, peak device memory in GB)."""
        path_soa.scene_soa_from_aos(scene_to(scene, dev))  # tables outside the wall
        for d in (bk.LAUNCHES, pk.LAUNCHES, vp.HOST_READS):
            for k in d:
                d[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as stack:
            kept = [(stack.enter_context(_keep_calls(mod, name, pick)), into)
                    for mod, name, pick, into in keep]
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for got, into in kept:
            into.update(got)
        launches = {**bk.LAUNCHES, **pk.LAUNCHES}
        per = {k: v / spp for k, v in launches.items() if v}
        reads = {k: v / spp for k, v in vp.HOST_READS.items() if v}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rays = out[-1]
        print(f"phase {phase}: {label} 512x512 spp {spp}: wall {wall:.3f} s, rays {rays:.0f}, "
              f"{rays / wall / 1e6:.3f} Mrays/s, launches per sample {per}, host reads per "
              f"sample {reads}, peak device memory {peak:.2f} GB on {card}")
        missing = [k for k in need if not launches[k]]
        others = [k for k, v in launches.items() if v and k not in need]
        if missing or others:
            raise AssertionError(f"{label}: launched {launches}, needs exactly {need}")
        return out, wall, per, reads, peak

    def check_image(img, label):
        if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not img.mean() > 0:
            raise AssertionError(f"{label}: image not finite, not 512x512x3 or black")

    def hold_mean(phase, label, img, other, what, bound):
        rel = abs(float(img.mean()) - float(other.mean())) / float(other.mean())
        print(f"phase {phase}: {label}: mean {float(img.mean()):.6f}, {what} "
              f"{float(other.mean()):.6f}, rel diff {rel:.4f} (bound {bound}) on {card}")
        if not rel < bound:
            raise AssertionError(f"{label}: the mean is not {what}'s")

    # ---- phase 36: per-ray path at 512x512 ----
    t_phase = time.perf_counter()
    cbox = presets.cornell_box(512, 512, spp=PERRAY_SPP)
    box = ctx["scene"]
    if box.static.options.samples_per_pixel != PERRAY_SPP or box.static.use_brute_force:
        raise AssertionError("phase 7's scene is not the 4 spp BVH box")
    for label, scene, need, keep in (
            ("cbox", cbox, ("intersect", "occluded"),
             [(bk, "intersect_brute", _nth({(None, 2): "path cbox bounce cast"}), k1_kept),
              (bk, "occluded_brute", _nth({(None, 1): "path cbox shadow ray"}), k2_kept)]),
            ("icosphere box", box, ("packet_intersect", "packet_occluded"),
             [(pk, "trace_packets", _nth({(False, 2): "path icosphere box bounce cast",
                                          (True, 1): "path icosphere box shadow ray"},
                                         lambda a, kw: bool(kw.get("any_hit"))), k3_kept)])):
        (img, rays), wall, per, reads, _ = run(
            36, f"per-ray path, {label}", scene,
            lambda: render.render_samples(scene_to(scene, dev), path.trace_path,
                                          return_stats=True), PERRAY_SPP, need, keep)
        check_image(img, f"per-ray path, {label}")
        hold_mean(36, f"per-ray path, {label}", img, render.render(scene, device="cuda"),
                  "the SoA path image", 0.06)
        if label == "cbox":
            rows["K1"]["path cbox per sample"] = per["intersect"]
            rows["K2"]["path cbox per sample"] = per["occluded"]
        else:
            rows["K3 closest"]["path icosphere box per sample"] = per["packet_intersect"]
            rows["K3 any hit"]["path icosphere box per sample"] = per["packet_occluded"]
    t_phase = _phase_done(36, t_phase)

    # ---- phase 37: per-ray gradpath (render_gradpath) at 512x512 ----
    st = box.static
    box_g = box._replace(static=dataclasses.replace(st, options=dataclasses.replace(
        st.options, integrator="gradpath", max_depth=PERRAY_GRAD_DEPTH,
        samples_per_pixel=PERRAY_GRAD_BOX_SPP)))
    cbox_g = presets.cornell_box(512, 512, spp=PERRAY_SPP, integrator="gradpath",
                                 max_depth=PERRAY_GRAD_DEPTH)

    def offset_lanes(scene):  # a pass's offset lanes: 4 per base lane
        n_pix, spp = 512 * 512, scene.static.options.samples_per_pixel
        return 4 * n_pix * min(spp, max(1, gdpt.LANES_PER_PASS // n_pix))

    n4, n4_box = offset_lanes(cbox_g), offset_lanes(box_g)
    for label, scene, need, keep in (
            ("cbox", cbox_g, ("intersect", "occluded"),
             [(bk, "intersect_brute", _nth({(n4, 2): "gradpath cbox probe",
                                            (n4, 3): "gradpath cbox replay"}, lanes), k1_kept)]),
            ("icosphere box", box_g, ("packet_intersect", "packet_occluded"),
             [(pk, "trace_packets", _nth({((False, n4_box), 2): "gradpath icosphere box probe"},
                                         walk), k3_kept)])):
        spp = scene.static.options.samples_per_pixel
        (recon, aux, rays), wall, per, reads, peak = run(
            37, f"per-ray gradpath (render_gradpath, depth {PERRAY_GRAD_DEPTH}), {label}",
            scene, lambda: gdpt.render_gradpath(scene, device="cuda", return_aux=True,
                                                 return_stats=True),
            spp, need, keep)
        check_image(recon, f"per-ray gradpath, {label}")
        if not all(np.isfinite(a).all() for a in aux.values()) or not np.abs(aux["gx"]).mean() > 0:
            raise AssertionError("per-ray gradpath: auxiliary buffers not finite, or gx zero")
        hold_mean(37, f"per-ray gradpath, {label}, reconstruction", recon, aux["primal"],
                  "its primal", 0.02)
        key = "cbox" if label == "cbox" else "icosphere box"
        if label == "cbox":
            rows["K1"][f"gradpath {key} per sample"] = per["intersect"]
            rows["K2"][f"gradpath {key} per sample"] = per["occluded"]
        else:
            rows["K3 closest"][f"gradpath {key} per sample"] = per["packet_intersect"]
            rows["K3 any hit"][f"gradpath {key} per sample"] = per["packet_occluded"]
    t_phase = _phase_done(37, t_phase)

    # ---- phase 38: the per-ray final volpath version at 512x512 ----
    grid = presets.volpath_scene(
        version=6, width=512, height=512, g=0.6, with_diffuse_sphere=True,
        density=presets.medium_grid(VOL_GRID, 3, 0.8), albedo=presets.albedo_grid(VOL_GRID, 4),
        **FINAL_GRID)
    medium = presets.medium_box(512, 512, grid_res=VOL_GRID, version=6, **FINAL_BOX)
    if medium.static.use_brute_force or not grid.static.use_brute_force:
        raise AssertionError("the phase 38 scenes are not the brute-force grid and the BVH box")
    for label, scene, need, mod, name, into in (
            ("grid scene", grid, ("intersect",), bk, "intersect_brute", k1_kept),
            ("medium box", medium, ("packet_intersect",), pk, "trace_packets", k3_kept)):
        spp = scene.static.options.samples_per_pixel
        want = {("main", 0, 2): f"final {label} bounce cast",
                ("shadow", 0, 2): f"final {label} shadow segment"}
        with _record_casts(trs, mod, name, want) as kept:
            (img, rays), wall, per, reads, _ = run(
                38, f"per-ray final volpath (depth {scene.static.options.max_depth}), {label}",
                scene, lambda: render.render_samples(scene_to(scene, dev), vp.trace_volpath_final,
                                                     return_stats=True), spp, need)
        into.update(kept)
        check_image(img, f"final volpath, {label}")
        t0 = time.perf_counter()
        soa = render.render(scene, device="cuda")
        print(f"phase 38: volpath_soa on the same scene: {time.perf_counter() - t0:.3f} s "
              f"on {card}")
        hold_mean(38, f"per-ray final volpath, {label}", img, soa, "volpath_soa's", 0.06)
        if label == "grid scene":
            rows["K1"]["final grid scene per sample"] = per["intersect"]
        else:
            rows["K3 closest"]["final medium box per sample"] = per["packet_intersect"]
    t_phase = _phase_done(38, t_phase)

    # ---- phase 39: cuda against cpu, the golden, the kernels on the recorded batches ----
    small = {"path": presets.cornell_box(32, 32, spp=2, max_depth=4),
             "gradpath": presets.cornell_box(32, 32, spp=2, max_depth=4, integrator="gradpath"),
             "final volpath": _small_volpath(presets)}
    for label, sc in small.items():
        outs = {}
        for d in ("cuda", "cpu"):
            if label == "gradpath":
                recon, aux, r = gdpt.render_gradpath(sc, seed=3, device=d, return_aux=True,
                                                     return_stats=True)
                outs[d] = (dict(aux, recon=recon), r)
            else:
                fn = path.trace_path if label == "path" else vp.trace_volpath_final
                img, r = render.render_samples(scene_to(sc, d), fn, seed=3, return_stats=True)
                outs[d] = ({"image": img}, r)
        (a, ra), (b, rb) = outs["cuda"], outs["cpu"]
        scale = float(b.get("primal", b.get("image")).mean())
        for k in a:
            _gate_cuda_vs_cpu(a[k], b[k], scale, 39, f"per-ray {label}, {k}")
        print(f"phase 39: per-ray {label}: rays cuda {ra:.0f}, cpu {rb:.0f}")
        if ra != rb:
            raise AssertionError(f"per-ray {label}: cuda and cpu ray counts differ")
    root = os.path.dirname(os.path.abspath(__file__))
    golden = gimage.read_exr(os.path.join(root, "tests", "goldens", "cbox_gdpt.exr"))
    img = gdpt.render_gradpath(presets.cornell_box(width=48, height=48, spp=16,
                                                   integrator="gradpath", max_depth=5),
                               seed=42, device="cuda")
    rel = float(np.sqrt(((img - golden) ** 2).mean())) / max(float(np.abs(golden).mean()), 1e-3)
    print(f"phase 39: cbox_gdpt golden on cuda through render_gradpath: RMSE / mean {rel:.4g} "
          f"(bound 0.05)")
    if not rel < 0.05:
        raise AssertionError("the cbox_gdpt golden fails on the card")

    expect = ({"path cbox bounce cast", "gradpath cbox probe", "gradpath cbox replay",
               "final grid scene bounce cast", "final grid scene shadow segment"},
              {"path cbox shadow ray"},
              {"path icosphere box bounce cast", "path icosphere box shadow ray",
               "gradpath icosphere box probe", "final medium box bounce cast",
               "final medium box shadow segment"})
    if (set(k1_kept), set(k2_kept), set(k3_kept)) != expect:
        raise AssertionError(f"phases 36-38 kept K1 {sorted(k1_kept)}, K2 {sorted(k2_kept)}, "
                             f"K3 {sorted(k3_kept)}")
    for key, (args, _) in sorted(k1_kept.items()):
        _compare_k1(bk.intersect_brute(*args), bk.intersect_brute_plain(*args), key)
        n_live, ops, nbytes = _brute_work("K1", args)
        n = args[10].shape[0]
        rows["K1"][key] = _time_batch(
            "K1", lambda: bk.intersect_brute(*args), (ops, nbytes), 39,
            f"{key} batch ({n} lanes, live {n_live / n:.4f}, tnear {args[11]:g})", card)
    for key, (args, _) in sorted(k2_kept.items()):
        live = args[10] > float(torch.tensor(args[11], dtype=torch.float32))
        _compare_k2(bk.occluded_brute(*args), bk.occluded_brute_plain(*args), key, live)
        n_live, ops, nbytes = _brute_work("K2", args)
        n = args[10].shape[0]
        rows["K2"][key] = _time_batch(
            "K2", lambda: bk.occluded_brute(*args), (ops, nbytes), 39,
            f"{key} batch ({n} lanes, live {n_live / n:.4f})", card)
    for key, ((tab, *r), kw) in sorted(k3_kept.items()):
        any_hit, n_tris = bool(kw.get("any_hit")), kw.get("n_tris")
        _compare_k3(pk, tab, tuple(r), n_tris, any_hit, key)
        ops, nbytes, _, visits = _walk_work(pk, tab, tuple(r), any_hit)
        n = r[0].shape[0]
        row = "K3 any hit" if any_hit else "K3 closest"
        rows[row][key] = _time_batch(
            row, lambda: pk.trace_packets(tab, *r, n_tris=n_tris, any_hit=any_hit),
            (ops, nbytes), 39, f"{key} batch ({n} lanes, live "
            f"{float((r[7] > r[6]).float().mean()):.4f}, {visits / n:.2f} visits per ray, "
            f"{tab.width}-wide table)", card)
    _phase_done(39, t_phase)
    return rows


def _camera_rays_spp(scene, dev, spp):
    """`spp` jittered camera rays per pixel of `scene` (seed 7), as V3s:
    phase 40's 512x512x4 set."""
    import numpy as np
    import torch

    from gdpt_tpu_torch.core import soa
    from gdpt_tpu_torch.integrators import path_soa
    from gdpt_tpu_torch.scene.build import scene_to

    st = scene.static
    ys, xs = np.mgrid[0:st.height, 0:st.width]
    xs_d = torch.as_tensor(np.tile(xs.ravel(), spp), dtype=torch.float32, device=dev)
    ys_d = torch.as_tensor(np.tile(ys.ravel(), spp), dtype=torch.float32, device=dev)
    u0, u1 = soa.uniform2(7, torch.arange(xs_d.shape[0], device=dev), 0, 0)
    cam = scene_to(scene, dev).device.camera
    return path_soa.primary_rays_soa(st, cam, xs_d, ys_d, u0, u1)


def _dispatch_lanes(pt, fn):
    """fn() with packet_trace._entry_dispatch wrapped: returns (fn's
    result, the lanes each two-phase dispatch cast, in order; the last
    dispatch of a cast is its root walk)."""
    seen, real = [], pt._entry_dispatch

    def counting(tab, org, d, tnear, tfar, entry_id, *a):
        seen.append(int((entry_id < tab.entry_ref.shape[0]).sum()))
        return real(tab, org, d, tnear, tfar, entry_id, *a)

    pt._entry_dispatch = counting
    try:
        return fn(), seen
    finally:
        pt._entry_dispatch = real


def _ties(pk, geo9, rays, idx, prims, t_ref, n_tris=None):
    """How many of the rays `idx` are ties: each cast's primitive (prims,
    one (N,) tensor per cast) is hit at the ray's t_ref."""
    import torch

    if not idx.numel():
        return 0
    o, d = torch.stack(rays[:3], 1)[idx], torch.stack(rays[3:6], 1)[idx]
    tn = rays[6][idx][:, None]
    tie = torch.ones(idx.numel(), dtype=torch.bool, device=idx.device)
    for prim in prims:
        p = prim[idx]
        geo = geo9[p.clamp_min(0).long()][:, None, :]
        tt, hit = pk._prim_hits(geo, p[:, None], tuple(o.T[:, :, None]), tuple(d.T[:, :, None]),
                                tn, torch.full_like(tn, 3e37), n_tris)
        tie = tie & hit[:, 0] & (tt[:, 0] == t_ref[idx])
    return int(tie.sum())


def _compare_two_phase(pk, tab, rays, got, ref, any_hit, label):
    """A two-phase cast against the single-phase cast of the same rays:
    no ray may differ in t or in the any-hit mask, and a ray whose prim
    differs must be a tie (both primitives hit at that same t). Returns
    (rays whose prim differs, max abs err of t)."""
    import torch

    if any_hit:
        n_bad = int(((got[1] >= 0) != (ref[1] >= 0)).sum())
        print(f"  two-phase any hit {label}: {got[1].numel()} rays, the blocked mask differs on "
              f"{n_bad}, blocked {float((ref[1] >= 0).float().mean()):.4f}")
        if n_bad:
            raise AssertionError(f"the two-phase any-hit mask differs from single-phase on {label}")
        return 0, 0.0
    bad_t = int((got[0].view(torch.int32) != ref[0].view(torch.int32)).sum())
    diff = torch.nonzero(got[1] != ref[1]).squeeze(1)
    ties = _ties(pk, tab.geo9, rays, diff, (got[1], ref[1]), ref[0])
    err = float((got[0] - ref[0]).abs().max()) if got[0].numel() else 0.0
    print(f"  two-phase closest {label}: {got[0].numel()} rays, t differs on {bad_t}, prim on "
          f"{diff.numel()} ({ties} of them ties), hits "
          f"{float((ref[1] >= 0).float().mean()):.4f}")
    if bad_t or diff.numel() != ties:
        raise AssertionError(f"the two-phase walk differs from single-phase on {label}")
    return diff.numel(), err


def _variant_phases(card, ctx):
    """Phases 40-41: the opt-in ray-casting variants at full width: the
    two-phase entry traversal (K3, K4) on phase 7's icosphere box, and the
    pool-sorted wavefronts of path, gradpath and volpath. Returns
    {kernel row: {ray set: two-phase numbers}} for the kernels line."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import packet_trace as pt
    from gdpt_tpu_torch.core.soa import V3
    from gdpt_tpu_torch.integrators import gdpt_soa, path_soa, render, volpath_soa
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    dev = torch.device("cuda")
    scene, scene_dev = ctx["scene"], ctx["scene_dev"]
    st = scene_dev.static
    tab32 = path_soa.scene_soa_from_aos(scene_dev).geom.packet
    tab16 = path_soa.scene_soa_from_aos(scene_dev, wide=16).geom.packet
    rows = {"K3 closest": {}, "K3 any hit": {}, "K4 closest": {}, "K4 any hit": {}}

    # ---- phase 40: two-phase entry traversal, casts then a gradpath render ----
    t_phase = time.perf_counter()
    org, d = _camera_rays_spp(scene, dev, TWO_PHASE_CAMERA_SPP)
    n_cam = org.x.shape[0]
    camera = (*(c.contiguous() for c in org), *(c.contiguous() for c in d),
              torch.zeros(n_cam, device=dev), torch.full((n_cam,), 3e37, device=dev))
    sets = (("camera", camera, False), ("bounce", ctx["bounce"], False),
            ("shadow", ctx["shadow"], True))
    real_walk = pk.trace_packets

    def plain_walk(tab, *rays, dual=False, **kw):
        return (pk.trace_packets_dual_plain if dual else pk.trace_packets_plain)(tab, *rays, **kw)

    for walker, tab, dual in (("K3", tab32, False), ("K3", tab16, False), ("K4", tab16, True)):
        for name, r, any_hit in sets:
            o3, d3 = V3(*r[:3]), V3(*r[3:6])
            n = r[0].shape[0]
            label = f"{name} rays ({n}), {walker} on the {tab.width}-wide table"
            mode = ("packet_dual_" if dual else "packet_") + ("occluded" if any_hit else
                                                              "intersect")
            for k in pk.LAUNCHES:
                pk.LAUNCHES[k] = 0
            got, lanes = _dispatch_lanes(pt, lambda: pt.trace_two_phase(
                tab, o3, d3, r[6], r[7], any_hit=any_hit, dual=dual))
            launches = dict(pk.LAUNCHES)
            if launches[mode] != sum(m > 0 for m in lanes) or sum(launches.values()) != \
                    launches[mode]:
                raise AssertionError(f"two-phase {label}: launched {launches}")
            one = pt.trace_packet_soa(tab, o3, d3, r[6], r[7], any_hit=any_hit, dual=dual)
            torch.cuda.synchronize()
            _, err = _compare_two_phase(pk, tab, r, got, one, any_hit, label)
            # The kernels against the plain walks under the same two-phase
            # walk, on a cut of the set (a ray's result does not depend on
            # the others'), bit for bit.
            cut = tuple(c[:TWO_PHASE_CUT].contiguous() for c in r)
            oc, dc = V3(*cut[:3]), V3(*cut[3:6])
            mine = pt.trace_two_phase(tab, oc, dc, cut[6], cut[7], any_hit=any_hit, dual=dual)
            pk.trace_packets = plain_walk
            try:
                plain = pt.trace_two_phase(tab, oc, dc, cut[6], cut[7], any_hit=any_hit,
                                           dual=dual)
            finally:
                pk.trace_packets = real_walk
            torch.cuda.synchronize()
            bad = int(((mine[0].view(torch.int32) != plain[0].view(torch.int32))
                       | (mine[1] != plain[1])).sum())
            if bad:
                raise AssertionError(f"two-phase {label}: the kernel and the plain walk differ on "
                                     f"{bad} of {TWO_PHASE_CUT} rays")
            ms2 = _events_ms(lambda: [pt.trace_two_phase(tab, o3, d3, r[6], r[7], any_hit=any_hit,
                                                         dual=dual) for _ in range(3)], 3)
            ms1 = _events_ms(lambda: [pt.trace_packet_soa(tab, o3, d3, r[6], r[7],
                                                          any_hit=any_hit, dual=dual)
                                      for _ in range(3)], 3)
            live = int((r[7] >= r[6]).sum())
            root = lanes[-1] / max(live, 1)
            print(f"phase 40: {label}: two-phase {ms2:.3f} ms a cast, single-phase {ms1:.3f} ms "
                  f"(CUDA events over 3 eager casts each); {len(lanes)} dispatches cast "
                  f"{lanes} lanes, {launches[mode]} kernel launches a cast; {root:.4f} of the "
                  f"{live} live lanes reach the root walk; on a cut of {TWO_PHASE_CUT} rays the "
                  f"kernel equals the plain walk bit for bit; on {card}")
            key = f"{walker} {'any hit' if any_hit else 'closest'}"
            rows[key][f"{name} rays, {tab.width}-wide table"] = {
                "wall_ms": ms2, "single_phase_wall_ms": ms1, "launches_per_cast": launches[mode],
                "root_walk_share": root, "max_abs_err_vs_single_phase": err}

    st_g = dataclasses.replace(st, options=dataclasses.replace(
        st.options, integrator="gradpath", samples_per_pixel=TWO_PHASE_GRAD_SPP))
    grad = scene._replace(static=st_g)
    outs = {}
    for two_phase in (False, True):
        for k in pk.LAUNCHES:
            pk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        recon, aux, rays = render.render(grad, seed=0, device="cuda", return_aux=True,
                                         return_stats=True, two_phase=two_phase)
        wall = time.perf_counter() - t0
        outs[two_phase] = (recon, aux, rays, dict(pk.LAUNCHES))
        print(f"phase 40: icosphere box gradpath 512x512 spp {TWO_PHASE_GRAD_SPP}, two_phase="
              f"{two_phase}: wall {wall:.3f} s, rays {rays:.0f}, {rays / wall / 1e6:.2f} Mrays/s, "
              f"launches {outs[two_phase][3]} on {card}")
    (ra, aa, na, la), (rb, ab, nb, lb) = outs[True], outs[False]
    scale = float(ab["primal"].mean())
    _gate_cuda_vs_cpu(ra, rb, scale, 40, "gradpath recon", what="two-phase vs single-phase")
    for k in ("primal", "gx", "gy"):
        _gate_cuda_vs_cpu(aa[k], ab[k], scale, 40, f"gradpath {k}",
                          what="two-phase vs single-phase")
    if abs(na - nb) > 1e-3 * nb or not la["packet_intersect"] or not la["packet_occluded"]:
        raise AssertionError(f"two-phase gradpath: rays {na} against {nb}, launches {la}")
    t_phase = _phase_done(40, t_phase)

    # ---- phase 41: the pool-sorted wavefronts ----
    medium = presets.medium_box(512, 512, POOL_SORT_VOL_SPP, grid_res=VOL_GRID)
    st_p = dataclasses.replace(st, options=dataclasses.replace(
        st.options, samples_per_pixel=POOL_SORT_SPP["path"]))
    st_g = dataclasses.replace(st_g, options=dataclasses.replace(
        st_g.options, samples_per_pixel=POOL_SORT_SPP["gradpath"]))
    path_soa.scene_soa_from_aos(scene_to(medium, dev))  # tables outside the walls
    real_keys = pt._morton_keys
    n_keys = [0]

    def counted_keys(*a, **kw):
        n_keys[0] += 1
        return real_keys(*a, **kw)

    pt._morton_keys = counted_keys
    try:
        for label, sc_, need in (("icosphere box path", scene._replace(static=st_p), "K3"),
                                 ("icosphere box gradpath", scene._replace(static=st_g), "K3"),
                                 ("medium box volpath", medium, "K3")):
            outs = {}
            # The path render also runs with packet_sort=False: no cast
            # sorts its rays (the reference's GDPT_PACKET_SORT=0).
            variants = ("pool_sort=False", "pool_sort=True") + (
                ("packet_sort=False",) if label == "icosphere box path" else ())
            for variant in variants:
                for k in pk.LAUNCHES:
                    pk.LAUNCHES[k] = 0
                n_keys[0] = 0
                switch, value = variant.split("=")
                t0 = time.perf_counter()
                img, rays = render.render(sc_, seed=0, device="cuda", return_stats=True,
                                          **{switch: value == "True"})
                wall = time.perf_counter() - t0
                outs[variant] = (img, rays, dict(pk.LAUNCHES), n_keys[0])
                print(f"phase 41: {label} 512x512 spp {sc_.static.options.samples_per_pixel}, "
                      f"{variant}: wall {wall:.3f} s, rays {rays:.0f}, "
                      f"{rays / wall / 1e6:.3f} Mrays/s, {n_keys[0]} morton key sorts, "
                      f"launches {outs[variant][2]} on {card}")
            ib, nb, lb, kb = outs["pool_sort=False"]
            for variant in variants[1:]:
                ia, na, la, ka = outs[variant]
                _gate_cuda_vs_cpu(ia, ib, float(ib.mean()), 41, label,
                                  what=f"{variant} vs the default")
                if na != nb or not la["packet_intersect"]:
                    raise AssertionError(f"{variant} {label}: rays {na} against {nb}, "
                                         f"launches {la}")
                if variant == "packet_sort=False" and (ka or not kb):
                    raise AssertionError(f"{variant} {label}: {ka} morton key sorts against "
                                         f"{kb} with the casts sorting")
    finally:
        pt._morton_keys = real_keys

    # The argsorts' device time per iteration, each way, from the profiler's
    # kernel names (the pool sort once per chunk of k iterations, and every
    # cast's own sort when the pool is not sorted).
    camera_d = scene_dev.device.camera
    sc = path_soa.scene_soa_from_aos(scene_dev)
    for label, k_iters in (("path", 8), ("gradpath", 6)):
        sort_us = {}
        for pool_sort in (False, True):
            n_pix = st.width * st.height
            if label == "path":
                total = n_pix * POOL_SORT_SPP["path"]
                state = path_soa._wavefront_state(n_pix, path_soa._pool_width(total), total, 1,
                                                  dev)
                step = lambda s, ps=pool_sort: path_soa._wavefront_body(  # noqa: E731
                    st, camera_d, sc, s, ps)
                sort = lambda s: path_soa._pool_sort(s, sc.geom.packet)  # noqa: E731
            else:
                total = n_pix * POOL_SORT_SPP["gradpath"]
                state = gdpt_soa._gdpt_wavefront_state(st_g, camera_d, sc, total, 1,
                                                       path_soa._pool_width(total, 1 << 17))
                step = lambda s, ps=pool_sort: gdpt_soa._gdpt_wavefront_body(  # noqa: E731
                    st_g, camera_d, sc, st_g.used_material_kinds, s, ps)
                sort = lambda s: gdpt_soa._gdpt_pool_sort(s, sc.geom.packet)  # noqa: E731
            for _ in range(k_iters):  # fill the pool first
                state = step(state)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                if pool_sort:
                    state = sort(state)
                for _ in range(k_iters):
                    state = step(state)
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            sort_us[pool_sort] = sum(getattr(e, "self_device_time_total", 0) for e in kernels
                                     if "sort" in e.key.lower()) / k_iters
        print(f"phase 41: {label} wavefront, {k_iters} iterations under torch.profiler: sort "
              f"kernels' device time per iteration {sort_us[False]:.1f} us with every cast "
              f"sorting, {sort_us[True]:.1f} us with the pool sorted once per chunk: "
              f"{sort_us[False] - sort_us[True]:.1f} us saved per iteration on {card}")
    _phase_done(41, t_phase)
    return rows


def _sharding_phase(card, ctx):
    """Phase 42: sharded renders (parallel/sharding.py) on the card: each
    against its unsharded banded render, bit for bit, and ray counts as
    the reference counts them."""
    import dataclasses

    import numpy as np
    import torch

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.integrators import gdpt_soa, path, path_soa, render, volpath_soa
    from gdpt_tpu_torch.parallel import sharding
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    card_mesh = sharding.make_mesh()
    mesh4 = sharding.make_mesh([dev] * 4)
    print(f"phase 42: make_mesh() = {card_mesh.devices}; the four-entry mesh {mesh4.devices}")
    if card_mesh.devices != (torch.device("cuda", 0),):
        raise AssertionError(f"make_mesh() on one card gave {card_mesh.devices}")
    box = ctx["scene"]
    st = box.static
    box_g = box._replace(static=dataclasses.replace(st, options=dataclasses.replace(
        st.options, integrator="gradpath", samples_per_pixel=SHARD_GRAD_SPP,
        max_depth=SHARD_GRAD_DEPTH)))
    grid = presets.volpath_scene(
        version=6, width=512, height=512, g=0.6, with_diffuse_sphere=True,
        density=presets.medium_grid(VOL_GRID, 3, 0.8), albedo=presets.albedo_grid(VOL_GRID, 4),
        **SHARD_GRID)
    cbox = presets.cornell_box(512, 512, spp=SHARD_PATH_SPP)

    def timed(fn):
        for d in (bk.LAUNCHES, pk.LAUNCHES):
            for k in d:
                d[k] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {**bk.LAUNCHES, **pk.LAUNCHES}

    cases = (
        ("cbox path (render_soa_sharded)", cbox, ("intersect", "occluded"),
         lambda s, m: sharding.render_soa_sharded(s, m, return_stats=True),
         lambda s: path_soa.render_soa(s, wavefront=False, return_stats=True), 128),
        ("icosphere box gradpath (render_gradpath_soa_sharded)", box_g,
         ("packet_intersect", "packet_occluded"),
         lambda s, m: sharding.render_gradpath_soa_sharded(s, m, return_stats=True),
         lambda s: gdpt_soa.render_gradpath_soa(s, wavefront=False, return_stats=True), 128),
        ("grid scene volpath (render_volpath_soa_sharded)", grid, ("intersect",),
         lambda s, m: sharding.render_volpath_soa_sharded(s, m, return_stats=True),
         lambda s: volpath_soa.render_volpath_soa(s, wavefront=False, return_stats=True), 128),
        ("cbox per-ray path (render_samples_sharded)", cbox, ("intersect", "occluded"),
         lambda s, m: sharding.render_samples_sharded(s, path.trace_path, m,
                                                      return_stats=True),
         lambda s: render.render_samples(s, path.trace_path, return_stats=True), 1),
    )
    for label, scene, need, sharded, single, align in cases:
        s_dev = scene_to(scene, dev)
        path_soa.scene_soa_from_aos(s_dev)  # tables outside the walls
        (one, one_rays), wall1, _ = timed(lambda: single(s_dev))
        meshes = [("four-entry mesh", mesh4)] + ([("make_mesh()", card_mesh)]
                                                 if label.startswith("cbox path") else [])
        for mesh_label, mesh in meshes:
            (img, rays), wall, launches = timed(lambda: sharded(scene, mesh))
            # Ray counts as the reference counts them: where no lane is
            # padded (512x512 pixels on these meshes), the unsharded count
            # (padded lanes would trace pixel 0: path and volpath add their
            # rays, gradpath scales a band's count by its real lanes).
            pad = sharding.ray_pad(mesh, scene.static.width * scene.static.height, align)
            print(f"phase 42: {label} over the {mesh_label}: wall {wall:.3f} s (unsharded banded "
                  f"{wall1:.3f} s), rays {rays:.0f} (unsharded {one_rays:.0f}, {pad} padded "
                  f"lanes), mean {float(np.mean(img)):.6f}, launches {launches} on {card}")
            missing = [k for k in need if not launches[k]]
            if missing or not np.array_equal(img, one) or not (pad or rays == one_rays):
                raise AssertionError(f"{label} over the {mesh_label}: differs from the unsharded "
                                     f"render, or did not launch {missing}")
    # A small image whose 900 pixels pad to 1,024 lanes on four entries.
    small = presets.cornell_box(30, 30, spp=2, max_depth=3)
    a, ra = sharding.render_soa_sharded(small, mesh4, seed=3, return_stats=True)
    b, rb = sharding.render_soa_sharded(small, sharding.make_mesh(["cpu"] * 4), seed=3,
                                        return_stats=True)
    _gate_cuda_vs_cpu(a, b, float(b.mean()), 42, "sharded cbox path 30x30 (900 pixels, 124 "
                      "padded lanes)", what="cuda vs cpu")
    print(f"phase 42: sharded 30x30 rays cuda {ra:.0f}, cpu {rb:.0f}")
    if ra != rb or not sharding.ray_pad(mesh4, 900):
        raise AssertionError("the sharded 30x30 render's ray counts differ between cuda and cpu")
    _phase_done(42, t_phase)


def _compare_walk(pk, geo9, rays, got, ref, any_hit, label, n_tris=None):
    """A walk's cast against a packet kernel's on the same rays: t of a
    ray that both hit equal within an ulp, a differing prim only on a tie
    (both primitives hit at that t), the hit (or any-hit) masks equal but
    on rays that graze a box in one tree and not in the other: they are
    counted, and as in phase 8 held to 0.1% of the rays, those that are
    not a re-hit of the ray's own wall within 2 tnear to 0.01%. Returns
    {"rays": n, "mask_differs": ..., "grazing_off_wall": ..., "t_ulp1": ...,
    "prim_ties": ..., "max_abs_err": ...}."""
    import torch

    n = rays[0].shape[0]
    if any_hit:
        diff = torch.nonzero(got != ref).squeeze(1)
        near = 0
    else:
        (gt, gp), (rt, rp) = got, ref
        gh, rh = gp >= 0, rp >= 0
        diff = torch.nonzero(gh != rh).squeeze(1)
        # A ray hit in one cast and not the other: a graze; near the
        # ray's own origin when the hit's t is under 2 tnear.
        t_hit = torch.where(gh, gt, rt)[diff]
        near = int((t_hit < 2.0 * rays[6][diff]).sum())
    out = {"rays": n, "mask_differs": int(diff.numel()),
           "grazing_off_wall": int(diff.numel()) - near,
           "walk_only": int(got[diff].sum()) if any_hit else int(gh[diff].sum())}
    if diff.numel() and diff.numel() <= 20:
        print(f"  {label}: rays {diff.tolist()} differ in the hit mask")
    if not any_hit:
        both = gh & rh
        du = (gt.view(torch.int32).long() - rt.view(torch.int32).long()).abs()
        off = both & (du > 1)
        out["t_ulp1"] = int((both & (du == 1)).sum())
        out["t_differs"] = int(off.sum())
        pdiff = torch.nonzero(both & ~off & (gp != rp)).squeeze(1)
        out["prim_ties"] = _ties(pk, geo9, rays, pdiff, (gp, rp), rt, n_tris)
        out["prim_not_tie"] = int(pdiff.numel()) - out["prim_ties"]
        out["max_abs_err"] = float((gt - rt)[both].abs().max()) if bool(both.any()) else 0.0
    print(f"  {label}: {n} rays, the {'any-hit' if any_hit else 'hit'} mask differs on "
          f"{out['mask_differs']} ({out['walk_only']} hit by the walk alone, "
          f"{out['grazing_off_wall']} off the ray's own wall)"
          + ("" if any_hit else f", t differs by one ulp on {out['t_ulp1']} and by more on "
             f"{out['t_differs']}, prim on {out['prim_ties']} ties and "
             f"{out['prim_not_tie']} others"))
    if (out["mask_differs"] > n // 1000 or out["grazing_off_wall"] > n // 10000
            or out.get("t_differs", 0) or out.get("prim_not_tie", 0)):
        raise AssertionError(f"the walk disagrees with the kernel on {label}")
    return out


def _walk_phases(card, ctx):
    """Phases 43-44: the reference's XLA walks (plain PyTorch) on the
    icosphere box at full width, held against K3, K4 and K1/K2, then the
    icosphere box's path rendered through them. Returns {kernel row:
    {walk on ray set: numbers}} for the kernels line."""
    import dataclasses

    import numpy as np
    import torch

    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.accel import super16 as s16
    from gdpt_tpu_torch.accel import traverse as ttr
    from gdpt_tpu_torch.accel import traverse_soa as trs
    from gdpt_tpu_torch.core.soa import V3
    from gdpt_tpu_torch.integrators import path_soa, render
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.scene.build import scene_to

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    scene = ctx["scene"]
    scene_dev = scene_to(scene, dev)
    st = scene_dev.static
    tab32 = path_soa.scene_soa_from_aos(scene_dev).geom.packet
    tab16 = path_soa.scene_soa_from_aos(scene_dev, wide=16).geom.packet
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = path_soa.scene_soa_from_aos(scene_dev, packet=False).geom
    torch.cuda.synchronize()
    t_packed = time.perf_counter() - t0
    t0 = time.perf_counter()
    gs = path_soa.scene_soa_from_aos(scene_dev, max_table_mb=0).geom
    torch.cuda.synchronize()
    t_sup = time.perf_counter() - t0
    sup = gs.sup16
    if gp.bvh_nodes48 is None or gp.packet is not None or sup is None or gs.packet is not None:
        raise AssertionError("the views of packet=False and max_table_mb=0 hold the wrong tables")
    print(f"phase 43: icosphere box views: packed table {tuple(gp.bvh_nodes48.shape)} "
          f"({gp.bvh_nodes48.numel() * 4 / 1e6:.1f} MB) and BVH arrays in {t_packed:.2f} s; "
          f"super16 table {tuple(sup.table.shape)} int32 ({sup.table.numel() * 4 / 1e6:.1f} MB), "
          f"L = {sup.leaf}, stack {sup.stack_n}, in {t_sup:.2f} s")
    geom = scene_dev.device.geom
    cam = tuple(c[:WALK_CAMERA].contiguous() for c in ctx["cam"])
    sets = (("bounce", ctx["bounce"], False), ("shadow", ctx["shadow"], True),
            ("camera", cam, False))

    def walks(any_hit):
        """name -> fn(o, d, tnear, tfar) returning (result, per-lane steps)."""
        def packed(o, d, tn, tf):
            hit, _, steps = trs.intersect_bvh_packed(st, gp, o, d, tn, tf, count_steps=True)
            return (hit.prim_id >= 0 if any_hit else (hit.t, hit.prim_id)), steps

        def per_lane(o, d, tn, tf):
            hit, steps = trs.intersect_bvh_soa(st, gp, o, d, tn, tf, count_steps=True)
            return (hit.prim_id >= 0 if any_hit else (hit.t, hit.prim_id)), steps

        def super16(o, d, tn, tf):
            s = s16._traverse(sup, o, d, tn, tf, any_hit=any_hit, count_steps=True)
            return (s["prim"] >= 0 if any_hit else (s["t"], s["prim"])), s["steps"]

        def per_ray(o, d, tn, tf):
            oo, dd = torch.stack(tuple(o), 1), torch.stack(tuple(d), 1)
            if any_hit:
                return ttr.occluded_bvh(geom, oo, dd, tn, tf, count_steps=True)
            hit, steps = ttr.intersect_bvh(geom, oo, dd, tn, tf, count_steps=True)
            return (hit.t, hit.prim_id), steps

        return (("packed", packed, trs.HOST_READS, "intersect_bvh_packed"),
                ("per_lane", per_lane, trs.HOST_READS, "intersect_bvh_soa"),
                ("super16", super16, s16.HOST_READS, "super16"),
                ("traverse", per_ray, ttr.HOST_READS,
                 "occluded_bvh" if any_hit else "intersect_bvh"))

    rows = {k: {} for k in ("K1", "K2", "K3 closest", "K3 any hit", "K4 closest",
                            "K4 any hit")}
    for set_name, r, any_hit in sets:
        o3, d3 = V3(*r[:3]), V3(*r[3:6])
        n = r[0].shape[0]
        kernels = {}
        for kname, tab, dual in (("K3", tab32, False), ("K4", tab16, True)):
            t, prim = pk.trace_packets(tab, *r, any_hit=any_hit, dual=dual)
            kernels[kname] = prim >= 0 if any_hit else (t, prim)
        torch.cuda.synchronize()
        for name, fn, reads, key in walks(any_hit):
            out = []
            before = reads[key]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = _events_ms(lambda: out.append(fn(o3, d3, r[6], r[7])), 1)
            peak = (torch.cuda.max_memory_allocated() - base) / 1e6
            got, steps = out[0]
            host_reads = reads[key] - before
            sf = steps.float()
            print(f"phase 43: {name} walk, {set_name} rays ({n}, "
                  f"{'any hit' if any_hit else 'closest'}): wall {ms:.1f} ms (CUDA events, "
                  f"one eager call), steps mean {float(sf.mean()):.1f} max {int(steps.max())}, "
                  f"{host_reads} host reads, peak device memory {peak:.1f} MB on {card}")
            nums = {"wall_ms": ms, "steps_mean": float(sf.mean()), "steps_max": int(steps.max()),
                    "host_reads": host_reads, "peak_mb": peak}
            for kname in (("K3", "K4") if name in ("packed", "super16") else ("K3",)):
                tab = tab32 if kname == "K3" else tab16
                cmp = _compare_walk(pk, tab.geo9, r, got, kernels[kname], any_hit,
                                    f"{name} walk vs {kname} on the {tab.width}-wide table, "
                                    f"{set_name} rays")
                row = f"{kname} {'any hit' if any_hit else 'closest'}"
                rows[row][f"{name} walk, {set_name} rays"] = dict(nums, **cmp)

    # traverse's brute-force casts against K1 / K2 on phase 2's cbox rays.
    cbox = scene_to(presets.cornell_box(512, 512, spp=SPP_MAIN), dev)
    sc = path_soa.scene_soa_from_aos(cbox)
    cst = cbox.static
    soups = (sc.geom.tri_soup, sc.geom.sph_soup, cst.n_tris, cst.n_spheres)
    org, d = _camera_rays(cbox, dev)
    n = org.x.shape[0]
    big = torch.full((n,), bk.BIG, device=dev)
    hit = bk.intersect_brute(*soups, *org, *d, big, 0.0)
    pos, rd, dl, tfar, _ = _secondary_rays(org, d, hit[0], hit[1], cst.shadow_epsilon)
    cgeom = cbox.device.geom
    eps, seps = cst.intersection_epsilon, cst.shadow_epsilon
    sph9 = torch.cat([cgeom.sph_center, cgeom.sph_radius[:, None],
                      torch.zeros((cst.n_spheres, 5), device=dev)], 1)
    geo9 = torch.cat([torch.cat([cgeom.tri_v0, cgeom.tri_e1, cgeom.tri_e2], 1), sph9])
    for set_name, (o, dd, tn, tf), any_hit in (
            ("camera", (tuple(org), tuple(d), 0.0, big), False),
            ("bounce", (pos, rd, eps, big), False),
            ("shadow", (pos, dl, seps, tfar), True)):
        oo, ddd = torch.stack(o, 1), torch.stack(dd, 1)
        out = []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if any_hit:
            ms = _events_ms(lambda: out.append(ttr.occluded_brute(cgeom, oo, ddd, tn, tf)), 1)
            ref = bk.occluded_brute(*soups, *o, *dd, tf, tn) > 0
        else:
            ms = _events_ms(lambda: out.append(ttr.intersect_brute(cgeom, oo, ddd, tn, tf)), 1)
            ref = bk.intersect_brute(*soups, *o, *dd, tf, tn)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e6
        got = out[0] if any_hit else (out[0].t, out[0].prim_id)
        ref = ref if any_hit else (torch.where(ref[1] >= 0, ref[0], tf), ref[1])
        kname = "K2" if any_hit else "K1"
        tn_lanes = torch.full((n,), float(tn), device=dev)
        rays = (*o, *dd, tn_lanes, tf)
        cmp = _compare_walk(pk, geo9, rays, got, ref, any_hit,
                            f"traverse brute force vs {kname}, cbox {set_name} rays",
                            cst.n_tris if cst.n_spheres else None)
        if cmp["mask_differs"] or cmp.get("prim_not_tie", 0):
            raise AssertionError(f"traverse's brute force differs from {kname} on the cbox's "
                                 f"{set_name} rays")
        print(f"phase 43: traverse.{'occluded' if any_hit else 'intersect'}_brute, cbox "
              f"{set_name} rays ({n}): wall {ms:.1f} ms (CUDA events, one eager call), peak "
              f"device memory {peak:.1f} MB, equal to {kname} on {card}")
        rows[kname][f"traverse brute force, cbox {set_name} rays"] = dict(
            cmp, wall_ms=ms, peak_mb=peak)
    t_phase = _phase_done(43, t_phase)

    # ---- phase 44: the icosphere box path through the two switches ----
    st1 = dataclasses.replace(scene.static, options=dataclasses.replace(
        scene.static.options, samples_per_pixel=WALK_SPP))
    one = scene._replace(static=st1)
    outs = {}
    for label, route, reads, key in (
            ("default", {}, None, None),
            ("packet=False", dict(packet=False), trs.HOST_READS, "intersect_bvh_packed"),
            ("max_table_mb=0", dict(max_table_mb=0), s16.HOST_READS, "super16")):
        for k in pk.LAUNCHES:
            pk.LAUNCHES[k] = 0
        before = reads[key] if reads else 0
        t0 = time.perf_counter()
        img, rays = render.render(one, seed=0, device="cuda", return_stats=True, **route)
        wall = time.perf_counter() - t0
        launches = dict(pk.LAUNCHES)
        walked = reads[key] - before if reads else 0
        outs[label] = (img, rays)
        print(f"phase 44: icosphere box path 512x512 spp {WALK_SPP}, {label}: wall {wall:.3f} s, "
              f"rays {rays:.0f}, {rays / wall / 1e6:.3f} Mrays/s, packet kernel launches "
              f"{sum(launches.values())}, walk host reads {walked} on {card}")
        if img.shape != (512, 512, 3) or not np.isfinite(img).all() or not img.mean() > 0:
            raise AssertionError(f"the {label} image is not finite, not 512x512x3 or black")
        if reads and (sum(launches.values()) or not walked):
            raise AssertionError(f"{label}: the render did not take its walk ({launches}, "
                                 f"{walked} host reads)")
    ib, nb = outs["default"]
    for label in ("packet=False", "max_table_mb=0"):
        ia, na = outs[label]
        _gate_cuda_vs_cpu(ia, ib, float(ib.mean()), 44, "icosphere box path",
                          what=f"{label} vs the default")
        if abs(na - nb) > 1e-3 * nb:
            raise AssertionError(f"{label}: rays {na} against {nb}")
    _phase_done(44, t_phase)
    return rows


def _zero_counts(*counters):
    for d in counters:
        for k in d:
            d[k] = 0


def _bench_row(bench, name, make, spp, sol, reduced=()):
    """bench_config's row (as printed, parsed back) and its rays."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.bench_config(name, make, spp, sol=sol, device="cuda", reduced=reduced)
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"phase 45: bench row {json.dumps(row)}")
    return row, bench.bench_config.last_rays


def _measurement_phase(card, ctx):
    """Phase 45: the measurement entry points (the FMA-peak kernel, the
    speed of light, the visit floor, the bench, the example and the entry
    points). Returns the FMA-peak kernel's row for the JSON line."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from gdpt_tpu_torch import bench, entry
    from gdpt_tpu_torch.accel import brute_kernels as bk
    from gdpt_tpu_torch.accel import packet_kernels as pk
    from gdpt_tpu_torch.examples import small_gdpt
    from gdpt_tpu_torch.integrators import render
    from gdpt_tpu_torch.scene import presets
    from gdpt_tpu_torch.tools import fma_peak as fp
    from gdpt_tpu_torch.tools import speed_of_light as sol_tool
    from gdpt_tpu_torch.tools import visit_microbench as vm

    t_phase = time.perf_counter()
    # ---- the FMA-peak kernel against its plain version (CPU only) ----
    small = fp.block(FMA_CHECK, "cuda")
    got = fp.fma_peak(small)
    t0 = time.perf_counter()
    ref = fp.fma_peak_plain(small.cpu())
    plain_ms = (time.perf_counter() - t0) * 1e3
    x = fp.block(fp.N, "cuda")
    full = fp.fma_peak(x)
    idx = torch.linspace(0, fp.N - 1, FMA_CHECK).long()
    ref_full = fp.fma_peak_plain(x[idx.cuda()].cpu())
    err, bits = 0.0, 0
    for g, r in [*zip(got, ref), *((f[idx.cuda()], r) for f, r in zip(full, ref_full))]:
        g = g.cpu()
        bits += int((g.view(torch.int32) != r.view(torch.int32)).sum())
        err = max(err, float((g - r).abs().max()))
        if not torch.allclose(g, r, rtol=1e-5, atol=0.0):
            raise AssertionError("the FMA-peak kernel disagrees with its plain version")
    ms = fp.time_ms(x)
    peak = fp.flops(fp.N) / (ms * 1e-3) / 1e9
    print(f"phase 45: FMA-peak kernel against its plain version on {FMA_CHECK} values and "
          f"{FMA_CHECK} of the {fp.N} of the timed block, {fp.STEPS} steps: max abs err "
          f"{err:.3g}, {bits} values differ in any bit; {ms:.3f} ms a launch, f32 peak "
          f"{peak:.1f} GFLOP/s measured against {fp.PUBLISHED_GFLOPS:.0f} published "
          f"({peak / fp.PUBLISHED_GFLOPS:.3f}); the plain version {plain_ms:.1f} ms for "
          f"{FMA_CHECK} values on the host's CPU, on {card}")
    if peak > 1.05 * fp.PUBLISHED_GFLOPS:
        raise AssertionError(f"the measured f32 peak {peak:.0f} GFLOP/s is over 105% of the "
                             f"published {fp.PUBLISHED_GFLOPS:.0f}")

    # ---- the speed of light: measure_kernels, chained casts held to one cast ----
    _zero_counts(fp.LAUNCHES, bk.LAUNCHES, pk.LAUNCHES)
    kept = []
    rows = sol_tool.measure_kernels(only={"cbox_512_path", "icosphere_box_gradpath"},
                                    m=1 << 20, keep=kept, out=lambda s: print(f"phase 45: {s}"))
    sol_launches = {**fp.LAUNCHES, **bk.LAUNCHES, **pk.LAUNCHES}
    print(f"phase 45: measure_kernels launched {sol_launches}")
    if not (sol_launches["fma_peak"] and sol_launches["intersect"] and sol_launches["occluded"]
            and sol_launches["packet_intersect"] and sol_launches["packet_occluded"]):
        raise AssertionError(f"measure_kernels did not launch every kernel: {sol_launches}")
    for label, last, cast in kept:
        one = cast()
        same = all(torch.equal(a, b) for a, b in zip(last, one))
        print(f"phase 45: chained {label} cast ({last[0].shape[0]} rays) equal to one cast: "
              f"{same}")
        if not same:
            raise AssertionError(f"the chained {label} cast differs from one cast")

    # ---- the visit floor of the icosphere box (K3 counts, K5 prices) ----
    _zero_counts(vm.LAUNCHES)
    floor = sol_tool.visit_row(ctx["scene_dev"], out=lambda s: print(f"phase 45: {s}"))
    print(f"phase 45: visit floor {json.dumps(floor)} on {card}")
    if not (vm.LAUNCHES["super32"] and vm.LAUNCHES["leaf24"]) or not floor["visits_per_ray_inc"]:
        raise AssertionError("the visit floor did not run K5 or counted no visits")

    # ---- the bench: the cbox (cut to 4 spp) and the icosphere box stand-in ----
    cbox = lambda: presets.cornell_box(width=512, height=512, spp=bench.CBOX_SPP,  # noqa: E731
                                       max_depth=6)
    want = {"spp", "wall_s", "spp_per_sec", "mean_radiance", "res", "platform"}
    _zero_counts(bk.LAUNCHES, pk.LAUNCHES)
    row, rays = _bench_row(bench, "cbox_512_path", cbox, SPP_MAIN, rows,
                           reduced=(f"spp: {SPP_MAIN} of {bench.CBOX_SPP}",))
    launches = {**bk.LAUNCHES, **pk.LAUNCHES}
    _, ref_rays = render.render(presets.cornell_box(512, 512, spp=SPP_MAIN, max_depth=6),
                                spp=SPP_MAIN, seed=0, device="cuda", return_stats=True)
    print(f"phase 45: cbox bench row: launches {launches}, rays {rays:.0f}, render.render "
          f"{ref_rays:.0f}")
    if (not want <= set(row["detail"]) or "mfu_est" not in row["detail"] or rays != ref_rays
            or not (launches["intersect"] and launches["occluded"])
            or row["detail"].get("reduced") != [f"spp: {SPP_MAIN} of {bench.CBOX_SPP}"]):
        raise AssertionError("the cbox bench row lacks a key, its cut, its kernels or its rays")
    box = ctx["scene"]
    grad = box._replace(static=dataclasses.replace(box.static, options=dataclasses.replace(
        box.static.options, integrator="gradpath")))
    cfg = {c.name: c for c in bench.CONFIGS}["icosphere_box_gradpath"]
    _zero_counts(bk.LAUNCHES, pk.LAUNCHES)
    row, rays = _bench_row(bench, cfg.name, lambda: grad, cfg.spp, rows, cfg.reduced)
    launches = {**bk.LAUNCHES, **pk.LAUNCHES}
    print(f"phase 45: icosphere box bench row: launches {launches}, rays {rays:.0f}, phase 15 "
          f"{ctx['grad_rays']:.0f}")
    if (not want <= set(row["detail"]) or rays != ctx["grad_rays"]
            or not (launches["packet_intersect"] and launches["packet_occluded"])):
        raise AssertionError("the icosphere box bench row lacks a key, its kernels or its rays")

    # ---- the example and the entry points ----
    _zero_counts(bk.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        recon, aux = small_gdpt.main(["2", "--width", "64", "--height", "48"])
        wall = time.perf_counter() - t0
        written = sorted(os.listdir(tmp))
    print(f"phase 45: small_gdpt 64x48 2 spp in {wall:.2f} s: mean recon {recon.mean():.6f}, "
          f"primal {aux['primal'].mean():.6f}, wrote {written}, launches {dict(bk.LAUNCHES)}")
    if (recon.shape != (48, 64, 3) or not np.isfinite(recon).all() or len(written) != 4
            or not bk.LAUNCHES["intersect"]):
        raise AssertionError("the small_gdpt example failed")
    _zero_counts(bk.LAUNCHES)
    fn, args = entry.entry()
    out = fn(*args)
    print(f"phase 45: entry(): {tuple(out.shape)} on {out.device}, mean "
          f"{float(out.mean()):.6f}, launches {dict(bk.LAUNCHES)}")
    if out.shape != (1024, 3) or not bool(torch.isfinite(out).all()) or not bk.LAUNCHES["intersect"]:
        raise AssertionError("entry() failed")
    t0 = time.perf_counter()
    entry.dryrun_multichip(4)
    print(f"phase 45: dryrun_multichip(4) on [cuda:0] * 4 passed in "
          f"{time.perf_counter() - t0:.2f} s")
    _phase_done(45, t_phase)
    row = _kernel_row("fma_peak (speed-of-light f32 peak)", "gdpt_tpu_torch/csrc/fma_peak.cu",
                      "tools/speed_of_light.py:353 (measure_vpu_peak, an XLA loop, not a "
                      "pallas_call)", sol_launches["fma_peak"], err, ms, plain_ms, 20 * fp.N,
                      fp.flops(fp.N))
    row["plain_on"] = f"the host's CPU, {FMA_CHECK} of the {fp.N} values"
    return row


def _stage_line(r):
    """A stage row of the tools as one line: wall, launches, device time
    where the profiler recorded the stage whole, the hand kernels' share,
    and the stage's span between CUDA events."""
    from gdpt_tpu_torch.utils.profiling import device_note

    return f"{r['wall_ms']:.3f} ms wall, {device_note(r)}"


def _check_stage_rows(phase, rows):
    """Every stage launched, the wrappers' K1-K4 launches are among its
    launches, and every row has its CUDA-event span; prints which rows
    the profiler did not record whole (their device time is None)."""
    timed = [r for r in rows if "wall_ms" in r and r.get("launches") is not None]
    if any(not r["launches"] or r["launches"] < r["hand_launches"] or not r["event_ms"] > 0
           for r in timed):
        raise AssertionError(f"phase {phase}: a stage launched nothing on the card")
    short = [r.get("stage", r.get("label")) for r in timed if not r["whole"]]
    print(f"phase {phase}: {len(timed) - len(short)} of {len(timed)} stage rows recorded whole "
          f"by the profiler" + (f"; not whole (device time not measured): {short}"
                                if short else ""))


def _ms(x):
    return "not measured" if x is None else f"{x:.3f} ms"


def _tool_phases(card, box_dev):
    """Phases 46-50: the stage profilers and the cast A/B tools of
    gdpt_tpu_torch/tools on their stand-in scenes (box_dev: phase 7's
    icosphere box on the card). Returns what K3's and K4's rows of the
    kernels line gain: phase 48's decomposition and phase 49's chain fits."""
    import torch

    from gdpt_tpu_torch.integrators import render
    from gdpt_tpu_torch.tools import (ab_dual_kernel, ab_wide_kernel, chain_sweep, occl_ab,
                                      occupancy_report, profile_nee, profile_render,
                                      profile_wavefront, stand_ins, trace_decompose)

    def emit(phase):
        return lambda line: print(f"phase {phase}: {line}")

    mat, info = stand_ins.load("material_box_bvh", device="cuda")
    cbox, _ = stand_ins.load("cbox", device="cuda")

    # ---- phase 46: profile_render, bounce by bounce ----
    t_phase = time.perf_counter()
    for label, scene in (("material_box_bvh", mat), ("cbox", cbox)):
        rows = profile_render.profile(scene, bounces=TOOL_BOUNCES)
        for r in rows:
            print(f"phase 46: {label} bounce {r['bounce']} {r['stage']} "
                  f"({r.get('live', r.get('rays'))} lanes): {_stage_line(r)}")
        profile_render.print_rows(rows, out=emit(46))
        hits = rows[1]["hits"]
        live1 = [r["live"] for r in rows if r["bounce"] == 1]
        print(f"phase 46: {label}: {hits} primary hits of {rows[0]['live']}, bounce 1 live "
              f"{live1[0] if live1 else 0}, on {card}")
        if not live1 or live1[0] != hits or not 0 < hits <= rows[0]["live"]:
            raise AssertionError(f"{label}: bounce 1's live lanes are not the primary hits")
        _check_stage_rows(46, rows)
    t_phase = _phase_done(46, t_phase)

    # ---- phase 47: profile_wavefront and profile_nee on the material box ----
    rows = profile_wavefront.profile(mat, pool=TOOL_POOL)
    for r in rows:
        if "wall_ms" in r:
            print(f"phase 47: wavefront {r['stage']}: {_stage_line(r)}")
    profile_wavefront.print_rows(rows, out=emit(47))
    by = {r["stage"]: r for r in rows}
    body = by["body"]
    # Each stage's device time where the profiler recorded it whole, else
    # its CUDA-event span, an upper bound on it: no lost record lowers the
    # sum.
    parts = [by[k] for k in by["sum"]["parts"]]
    stages = sum(r["device_ms"] if r["whole"] else r["event_ms"] for r in parts)
    busy = ("" if body["device_ms"] is None else
            f" ({body['device_ms'] / body['wall_ms']:.3f} busy)")
    print(f"phase 47: the material box's wavefront iteration ({TOOL_POOL} lanes): body "
          f"{body['launches']} launches (phase 23 counts 12,142 a path iteration at 4 spp), device "
          f"{_ms(body['device_ms'])} of {body['wall_ms']:.3f} ms wall{busy}; the stages' device "
          f"time at most {stages:.3f} ms ({sum(not r['whole'] for r in parts)} of {len(parts)} "
          f"by their event span), on {card}")
    if stages > body["wall_ms"]:
        raise AssertionError("the wavefront stages' device time exceeds the body's wall")
    _check_stage_rows(47, [r for r in rows if r["stage"] != "sum"])
    rows = profile_nee.profile(mat, pool=TOOL_POOL)
    _check_stage_rows(47, rows)
    for r in rows:
        if "wall_ms" in r:
            print(f"phase 47: nee {r['stage']}: {_stage_line(r)}"
                  + (f" ({r['live_shadow']} live shadow rays)" if "live_shadow" in r else ""))
        else:
            print(f"phase 47: nee pool {r['pool']}")
    t_phase = _phase_done(47, t_phase)

    # ---- phase 48: trace_decompose on the icosphere box's pool rays ----
    rows = trace_decompose.decompose(box_dev, pool=TOOL_POOL)
    trace_decompose.print_rows(rows, out=emit(48))
    by = {r["stage"]: r for r in rows}
    if by["check"]["rays_differing"]:
        raise AssertionError("the pre-sorted cast differs from the sorted cast")
    _check_stage_rows(48, rows)
    # device_ms is the profiler's, None where it did not record the stage
    # whole; event_ms the CUDA-event span, the device time of the walk and
    # of the unsort (one and two launches).
    decompose = {k: {key: by[k][key] for key in ("wall_ms", "event_ms", "device_ms",
                                                 "launches", "device_ops")}
                 for k in ("sort", "trace_sorted", "trace_presorted", "kernel", "kernel_any_hit",
                           "unsort", "hit_attribs")}
    print(f"phase 48: {by['rays']['rays']} pool rays, CUDA-event spans: sort "
          f"{by['sort']['event_ms']:.3f}, walk {by['kernel']['event_ms']:.3f}, unsort "
          f"{by['unsort']['event_ms']:.3f}, attributes {by['hit_attribs']['event_ms']:.3f}, the "
          f"whole cast {by['trace_sorted']['event_ms']:.3f} ms; profiler device time: sort "
          f"{_ms(by['sort']['device_ms'])}, walk {_ms(by['kernel']['device_ms'])}, unsort "
          f"{_ms(by['unsort']['device_ms'])}, attributes {_ms(by['hit_attribs']['device_ms'])}, "
          f"the whole cast {_ms(by['trace_sorted']['device_ms'])} "
          f"({by['trace_sorted']['wall_ms']:.3f} ms wall); the pre-sorted cast equal bit for "
          f"bit, on {card}")
    t_phase = _phase_done(48, t_phase)

    # ---- phase 49: the cast A/B tools ----
    for tool in (ab_dual_kernel, ab_wide_kernel):
        rows = tool.ab(box_dev, pool=TOOL_POOL)
        for r in rows:
            print(f"phase 49: {tool.__name__.rsplit('.', 1)[1]} {json.dumps(r)}")
        _check_stage_rows(49, rows)
    chain = {}
    for dual in (False, True):
        rows = chain_sweep.sweep(box_dev, dual=dual, pool=TOOL_POOL)
        for r in rows:
            print(f"phase 49: chain_sweep {'K4' if dual else 'K3'} {json.dumps(r)}")
        if not rows[0]["hit_frac"] > 0:
            raise AssertionError("chain_sweep: the cast hit nothing")
        fits = {r["fit"]: r for r in rows if "fit" in r}
        chain["K4 closest" if dual else "K3 closest"] = {
            "hit_frac": rows[0]["hit_frac"], "rays": rows[0]["rays"],
            "eager_C_ms": fits["eager"]["C_ms"], "eager_cast_ms": fits["eager"]["cast_ms"],
            "graph_C_ms": fits["graph"]["C_ms"], "graph_cast_ms": fits["graph"]["cast_ms"]}
    for label, scene in (("icosphere_box", box_dev), ("cbox", cbox)):
        rows = occl_ab.ab(scene, pool=TOOL_POOL)
        for r in rows:
            print(f"phase 49: occl_ab {label} {json.dumps(r)}")
        _check_stage_rows(49, rows)
    t_phase = _phase_done(49, t_phase)

    # ---- phase 50: occupancy_report against render.render ----
    grid, _ = stand_ins.load("volpath_grid6", device="cuda")
    for name, scene, spp in (("sponza", box_dev, OCC_SPP_PATH), ("volpath6", grid, OCC_SPP_VOL)):
        rows = occupancy_report.run(scene, name, spp_path=spp, spp_gdpt=OCC_SPP_GDPT,
                                    out=emit(50))
        for r in rows:
            img, rays = render.render(_with_integrator(scene, r["integrator"]), spp=r["spp"],
                                      seed=0, device="cuda", return_stats=True,
                                      wavefront=r["mode"] == "wavefront")
            mean = float(img.mean())
            print(f"phase 50: {name} {r['integrator']} {r['mode']}: render.render rays "
                  f"{rays:.0f}, mean {mean:.6f}; the tool's {r['rays']:.0f}, {r['mean']}")
            # The wavefront's scatter-add sums in no fixed order on the card.
            if rays != r["rays"] or abs(round(mean, 5) - r["mean"]) > 1e-5 * abs(mean) + 1e-5:
                raise AssertionError(f"occupancy_report's {name} {r['integrator']} "
                                     f"{r['mode']} row disagrees with render.render")
    _phase_done(50, t_phase)
    return decompose, chain


def _phase_done(phase, since):
    now = time.perf_counter()
    print(f"phase {phase}: done in {now - since:.1f} s")
    return now


def _resource_usage(lib):
    """{kernel entry (mangled): (registers, local memory bytes a thread)}
    of a built library, from the toolkit's cuobjdump; {} where there is
    none."""
    import re
    import shutil
    from pathlib import Path

    from gdpt_tpu_torch.accel import native_build

    tool = shutil.which("cuobjdump") or str(Path(native_build.nvcc()).parent / "cuobjdump")
    try:
        out = subprocess.run([tool, "-res-usage", str(lib)], capture_output=True, text=True,
                             timeout=60).stdout
    except OSError:
        return {}
    found = re.findall(r"Function (\S+):\s+REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", out)
    return {name: (int(reg), int(stack) + int(local)) for name, reg, stack, local in found}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from gdpt_tpu_torch.accel import native_build

    # ---- phase 1: card and build ----
    card = _card()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: card {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    libs = native_build.build_all(
        ["brute_intersect.cu", "packet_trace.cu", "packet_trace_dual.cu",
         "visit_microbench.cu", "fma_peak.cu", "path_fused.cu", "bvh_builder.cpp"],
        verbose=True)
    print(f"phase 1: built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    resources = {}
    for lib in libs[:6]:
        resources.update(_resource_usage(lib))
    use = {entry: [v for k, v in resources.items() if entry in k] for _, entry in KERNEL_ENTRIES}
    use = {entry: v[0] if v else (None, None) for entry, v in use.items()}
    print(f"phase 1: registers, local bytes a thread: "
          + ", ".join(f"{name} {use[entry]}" for name, entry in KERNEL_ENTRIES))

    rows, fused_rows = _brute_phases(card)
    k3_rows, ctx = _bvh_phases(card)
    rows += k3_rows + _gradpath_phases(card, ctx)
    sums = _batch_phase(card)
    _material_phases(card)
    k1_vol, k3_vol = _volpath_phases(card)
    _file_phases(card)
    rungs = _rung_phases(card)
    perray = _perray_phases(card, ctx)
    two_phase = _variant_phases(card, ctx)
    _sharding_phase(card, ctx)
    oracles = _walk_phases(card, ctx)
    rows += fused_rows
    rows.append(_measurement_phase(card, ctx))
    decompose, chain = _tool_phases(card, ctx["scene_dev"])
    if len(rows) != len(KERNEL_ENTRIES):
        raise AssertionError(f"{len(rows)} kernel rows for {len(KERNEL_ENTRIES)} entries")
    for row, (name, entry) in zip(rows, KERNEL_ENTRIES):
        row["registers"], row["local_bytes"] = use[entry]
    for row, name in zip(rows, ("K1", "K2")):
        row["us_per_sample"] = {r: v[name] for r, v in sums.items()}
    rows[0]["volpath_launches_per_sample"] = k1_vol
    rows[2]["volpath_launches_per_sample"] = k3_vol
    for row, name in zip(rows, ("K1", "K2", "K3 closest", "K3 any hit")):
        row["rungs"] = {k: (v if isinstance(v, (int, float)) else
                            {"ms": v[0], "bound_ms": v[1]}) for k, v in rungs[name].items()}
        row["perray"] = {k: (v if isinstance(v, (int, float)) else
                             {"ms": v[0], "bound_ms": v[1]}) for k, v in perray[name].items()}
    for row, name in zip(rows[2:6], ("K3 closest", "K3 any hit", "K4 closest", "K4 any hit")):
        row["two_phase"] = two_phase[name]
    for row, name in zip(rows[:6], ("K1", "K2", "K3 closest", "K3 any hit", "K4 closest",
                                    "K4 any hit")):
        row["oracles"] = oracles[name]
    rows[2]["decompose"] = {k: decompose[k] for k in ("sort", "trace_sorted", "trace_presorted",
                                                      "kernel", "unsort", "hit_attribs")}
    rows[3]["decompose"] = {k: decompose[k] for k in ("sort", "kernel_any_hit")}
    rows[2]["chain"] = chain["K3 closest"]
    rows[4]["chain"] = chain["K4 closest"]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
