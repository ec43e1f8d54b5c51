#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout.  It drives ``protstruc_tpu_torch`` on the
card in phases, prints one line per phase, and exits non-zero at the first
failure (no CUDA, a kernel that does not build or launch, a disagreement):

1. device: the card's name and power limit (nvidia-smi);
2. build: K1 (csrc/pair_maps.cu), K2 (csrc/pair_maps_bwd.cu), the K1
   probes P1-P3 (csrc/pair_maps_probe.cu), K3 (csrc/model_features.cu),
   K4-K7 (csrc/tri_mul.cu) and K8/K9 (csrc/flash_attn.cu) with nvcc, from
   the checkout's sources, the six builds started together;
3. parity at small sizes: K1 vs its plain PyTorch version on the card,
   bitwise (the count of unequal entries must be 0) and under the
   tolerances below, at B=2 and L = 1, 2, 31, 33, 37, 127, 129, 300, 512
   (the launch plan gives L % 4 != 0 scalar stores, the rest vector ones)
   and on degenerate probes, printing the plan's store path of each; a map
   subset written into six
   sentinel planes, only the selected ones touched (f32 and bf16); the bf16
   mode equal to the f32 planes cast to bf16 at L = 37;
4. parity at full size: B=256, L=512 on ``randn * 10`` (numpy seed 0),
   bitwise, and the bf16 mode equal to the f32 planes cast;
5. main path: ``StructureBatch.from_pdb`` on bundled PDBs, then
   ``precompile_featurizer(device="cuda")`` and ``serve_loop`` over JSONL
   requests; K1's launch counters are reset just before: the f32 one must
   grow, the bf16 mode's must stay 0 (the path serves f32 maps);
6. timing (CUDA events, 2 warm-up + 10 timed, plain/kernel/kernel/plain):
   K1 alone vs its plain version, K1's bf16 mode with its bound, and full
   featurization at B=256, L=512 on the kernel path vs the plain path, as
   structures/s;
7. triangle kernels: K4-K7 vs their plain versions on the card, f32 and
   bf16, C = 16, 64 (the FoldModel's pair width), 128 and 256 (in f32 the
   wide route of all four, in bf16 at 256 the wide route, the weight
   gradients in 128 x 128 tiles) on a ragged
   N = 2*37*37 with masked rows, and C = 128 on N =
   160*160 (more row tiles than blocks, so each block loops), every output
   and weight gradient; then the whole op (forward and backward, outgoing
   and incoming) vs the plain path on the CPU; f32 K4-K7 at the FoldModel
   shape (N = 4*256*256, C = 64: many tiles a warp in the resident
   passes); then K4-K7 at C = 64 on tensors (rows, weights, cotangents)
   that start off a 16-byte boundary;
8. train path: TrFold at the ``[mfu-fused]`` width of bench.py (bf16,
   D=256, P=128, 8 heads, 4 blocks, triangle updates, remat, fused_tri) on
   B=4, L=512 (``randn * 5``, numpy seed 0): ``featurize_for_model(
   use_kernel=True)`` (K1), ``make_train_state`` from a seeded generator and
   3 ``train_step``s, every launch counter reset just before and read just
   after (K4-K7 must grow); the same 3 steps from the same init with
   ``fused_tri=False`` (plain PyTorch); then the same at f32, B=1, L=128,
   with gradients compared leaf by leaf;
9. timing: the full-width train step, fused vs unfused (ms/step and peak
   memory; every step from the initial parameters, its loss finite; then one
   step of each under torch.profiler), and each
   of K4-K7 alone vs its plain version at N = 4*512*512, C = 128, bf16, the
   shape the train path gives it, after each output is held against the plain
   version's under the budgets below, then under torch.profiler, its device
   time split by the kernels of the call (K5 and K7: rows pass, weight-gradient
   pass, reductions); then 9b, the same train step and K4-K7 in float32 (the
   model's default dtype; all four on the wide route), the step's K4-K7
   launches counted by route (K4 and K6 16 each, K5 and K7 8, all wide),
   its losses within 1e-5 relative of unfused;
10. K3 vs its plain version at B=2 and L = 1, 2, 31, 33, 37, 127, 129, 300,
    512, the degenerate probes and B=256, L=512 (``randn * 10``, numpy seed
    0), f32 and bf16 planes;
11. K8/K9 vs their plain versions (forward, lse, ds, dk, dv and dq = ds k),
    f32 and bf16, at the train shape (B=4, H=4, dh=32, L=256) with the bias
    read through the model's permuted layout and with a contiguous bias (K8's
    element-wise and 16-byte bias copies), ragged L = 37 and 300 with a
    fully-masked batch row, L = 17 (shorter than one 64-row block), q/k/v
    rows off 16-byte alignment (K8's narrow copies), the JAX smoke gate's
    shapes (bench.py:977-997: B=1, H=2, L=96, last 8 keys masked, dh 16, 64
    and 128), B=1, H=1, dh=128, L=2048 (bf16; bench.py:1003-1012),
    bench.py's ``[attn]`` shape (B=1, H=8, dh=32, L=4096, last 100 keys
    masked) and B*H past 65535 (f32, B=16400, H=4, dh=16, L=17);
12. main path of the FoldModel slice: ``python -m protstruc_tpu_torch train``
    (in process) at ``experiments/fold_loo.py``'s configuration with
    ``--flash-attn`` (f32, B=4, crop 256, D=128, P=64, 4 heads, 4 blocks, 6
    IPA iterations, recycle 1, triangle updates, remat, fused_tri) over its
    training files (1REX held out, the duplicate 1a6v_JN left out), 8 steps,
    a checkpoint every 4 with an eval on 1REX; then ``fold`` of 1REX's
    sequence from that checkpoint into a PDB.  The K3, K4-K7 and K8/K9
    counters are reset just before and must grow.  Then one batch of real
    crops from one init, the kernel path against the plain path (K3's plain
    version, ``use_flash_attn`` and ``fused_tri`` off): loss and every
    gradient leaf;
13. timing: the FoldModel train step (featurization included), kernel path
    vs plain path (ms/step, peak memory, each step from the initial
    parameters), then one step of each under torch.profiler (device busy,
    the top kernels, and every K4-K7 kernel of the kernel path's step); K3
    at B=256, L=512; K8 and K9 at the train and ``[attn]``
    shapes, each beside its plain version and
    ``torch.nn.functional.scaled_dot_product_attention`` with the additive
    mask (its forward, and its backward over a kept graph), then the
    CUDA-event and torch.profiler device times of K8, K9, SDPA's forward,
    SDPA's backward, and the whole flash backward (delta, K9 and dq = ds k:
    what SDPA's backward computes);
14. K2 vs its plain version on card tensors: ragged L = 37 and 300, the
    degenerate probes, bench.py's degenerate batch (CB = CA on every third
    residue, residue 7 = residue 3; must be finite), a NaN residue, a map
    subset with a ``None`` cotangent, B=70000, L=5 (past 65535), and
    B=256, L=512 (cotangents ``randn`` from a card generator seeded 1), run
    twice: the two results must be the same bits;
15. main path of the gradient through features: ``from_pdb`` on bundled
    PDBs, ``inter_residue_geometry(use_kernel=True)`` on a leaf ``xyz`` (as
    parsed, and with missing atoms at 0), a loss over the six maps under
    their masks with seeded weights, ``backward``; then the same through
    ``featurize_for_model(use_kernel=True)`` at B=4, L=512.  The K1 and K2
    counters are reset just before and must grow; each ``xyz.grad`` is held
    against the plain backward of the same cotangents;
16. timing at B=256, L=512: K2 vs its plain version (as 4 calls of 64
    structures), and ``pairwise_maps`` forward + backward through autograd
    with its peak memory;
17. the K1 probes (experiments/kernel_probe.py): every variant, layout and
    block shape vs its plain version at L = 37 and 300, then P1 (the
    variant grid), P2 (packed outputs) and P3 (the block sweep) at B=256,
    L=512, the probe counter reset before each and read after; full
    against write-only splits K1's time into stores and the rest.
18. the served and analysis path: ``serve_loop(device="cuda")`` over phase
    12's checkpoint (ping, featurize of 1REX, analyze of 1REX, 4uuj, 8dtk,
    6dc4 and 1ad0_DC, fold of 1REX, of 1ad0_DC's two chains and of 1REX
    again, an unknown op, shutdown), the K4, K6 and K8 counters reset just
    before the first fold (they must grow, K5, K7 and K9 must not), every
    reply held to the same requests served on the CPU (analyze fields
    equal, an SS difference only through H-bond energies within 1e-4 of the
    cutoff, unrounded radius of gyration within 1e-5 max(1, |ref|); folded
    coordinates within 1e-3 A and pLDDT within 1e-2, unrounded, and the
    served PDBs within those plus one printed unit); ``analyze --ss8
    --sasa`` of the bundled structures as one batch (finite), and of 1REX
    (with SASA) and 15c8_HL against the CPU (each number within one unit of
    its printed digit, SS8 strings equal); ``score`` of the served fold
    against native 1REX, of 1REX and 1ad0_DC against themselves and of
    1ad0_DC with chain 1 moved 8 A; ``convert`` 15c8_HL pdb -> cif -> pdb;
    ``fold --relax 20``; then served request latency (p50, p90 of 20 after
    one warm-up) of analyze (1REX, 4uuj) and fold (1REX, 1ad0_DC), one
    fold of each under torch.profiler (K4, K6, K8 by name) and CUDA-event
    times of ``sasa``, ``clash_energy`` and ``secondary_structure`` on the
    bundled batch;
19. the batch API at BASELINE sizes (BASELINE.md:39-45, at bench.py:700-821's
    sizes), float32 matmuls without TF32 checked first, each configuration
    timed by CUDA events and held against the port's CPU path on the same
    inputs (coordinates and distances within 1e-5 + 1e-5 |ref|, masks
    bitwise): (1) 15c8_HL CA-CA distances and backbone dihedrals; (2) the
    8 PDBs padded to 512: ``pairwise_distance_matrix`` (B=8, 15 x 15 atoms,
    two structures against the CPU), orientations and translations, and
    ``from_backbone_orientations_translations`` back to the same frames
    (1e-5); (3) ``AntibodyStructureBatch.from_pdb`` of 6dc4 (H/L) x8 padded
    and tiled to B=64: omega, theta, phi, the heavy pair mask and the nine
    named masks; (4) B=256 (the 8 PDBs x32, NaN -> 0): ``standardize`` and
    a T=300 cosine-schedule ``diffusion_trajectory`` from a seeded card
    generator, structures 0-7 against the CPU core on the same draws, x_T
    std within 0.1 of 1; (5) B=1024, L=1024 uniform torsions (numpy seed
    1): ``from_dihedrals`` (the NeRF chain, error by residue against the CPU
    port and a float64 chain: the card no further from it than twice the
    CPU + 1e-5 A), the actual CB, the A=15 layout, K1 with ``maps=("d_cb",)``
    (its launch counter reset just before and read after: one launch),
    bitwise equal to its plain version on 16 structures, only d_cb written
    into six sentinel planes, timed against its plain version (16 calls of
    64) and its bound; then the reconstruction path on 1REX and 15c8_HL
    (``inter_residue_geometry(use_kernel=True)``, K1's counter reset before
    and grown after -> distmat -> ``initialize_backbone_with_mds``, 200
    SMACOF iterations): the CA distance-matrix RMS against the native under
    tests/test_reconstruct.py's 1.5 and 2.5 A, the distmat against the CPU
    port's, the MDS coordinates within 1e-3 A of the CPU's after a proper
    Kabsch fit; last ``renumber`` of 6dc4 to IMGT through the CLI, the file
    ingested on the card and the CPU (masks equal, CDR sizes as the Chothia
    file converted at ingest);
20. the design and generation path: (a) the AR InverseFold train step at
    ``experiments/r5_flash_if_ab.py``'s width (bf16, D=256, P=32, 8 heads,
    3 encoder + 3 decoder blocks) on 8gpi's first 2048 residues, flash
    (K8/K9 under the folded causal bias) against the einsum path: losses
    within 2e-2 relative, ms/step and peak memory, each path's device busy
    share in one profiled step, K8/K9 launches a step (counters reset just
    before); (b) K8/K9 against their plain versions at that shape on the
    folded causal bias with k/v from a second projection: out, lse, ds, dk,
    dv at the bf16 budget, the rows without an allowed key post-zeroed, their
    ds exactly 0 and dk/dv bitwise unchanged when their q and bias change;
    (c) each stage on the card against the port on the CPU from the same
    inputs and host-made draws: FrameDiff loss and one reverse step, IF
    logits (f32, einsum and flash), the AR-sampled sequence (equal),
    chi_angles, build_sidechains, pack_sidechains' energies,
    predict_structure's heads on a random-init TrFold (and the whole call
    on the card, finite), then its decode on heads that carry 1REX's own
    maps: d_cb, angles, MDS after a fit, idealize_backbone from the CPU's
    MDS start and the whole decode after a fit; (d) ms per decoded
    position of ``ar_sample_sequence`` at that width on L=256 and ms per
    reverse step of ``framediff_sample`` at ``FrameDiffConfig()`` on B=8,
    L=128; (e) the five example drivers on the card at their own sizes;
21. the scale-out path: (a) K1's rectangular ``xyz_j`` mode bitwise against
    its plain version (B=2, L = 37, 300, 512 in 1-4 row blocks, the
    degenerate probes), a map subset into sentinel planes (f32, bf16), bf16
    planes = the f32 planes cast; B=256, L=512 as 4 row blocks of 128
    bitwise equal to the square launch's rows, the 4 launches timed against
    the square launch and the bound; (b) K8/K9's lse entry point against the
    plain lse attention, f32 and bf16, train shape and ragged L=37 with a
    fully-masked row: out, lse (-inf exactly), ds, dq, dk, dv for random
    cotangents of both outputs, inf/NaN lse cotangents on the masked rows;
    (c) the ring's attend-and-merge over 4 blocks in each rank's visiting
    order against K8/K9 over the full L (f32, bf16, phase 11's budgets);
    (d) a one-rank NCCL group: ``ring_attention_sharded``,
    ``featurize_sharded(use_kernel=True)`` bitwise equal to the unsharded
    K1 maps, ``pipeline_apply`` with one stage against ``TrFold.forward``,
    ``train --mesh 1,1,1 --zero1`` in process (phase 12's configuration, 3
    steps) against the same steps without a mesh; K1's rectangular and
    K8/K9's counters reset just before and grown after; the lse entry's
    forward timed beside the plain version and
    ``_scaled_dot_product_efficient_attention(compute_log_sumexp=True)``;
    (e) ``[mfu-peak]`` (bench.py:348-351: bf16, D=2048, P=1024, 8 heads, 3
    blocks, triangle, remat, B=2, L=256, ``randn * 5``, numpy seed 0):
    K4-K7 through their wide route at C = 144, 160, 256 and 1024 on N =
    300, 81 and 2738 rows against their plain versions (each call's route
    read from the counters: all four wide); K4-K7 at the step's pair rows
    (N = 2*256*256) against their plain versions, and timed there beside
    them and their bounds, each call split by kernel under torch.profiler
    (a split kept only where it adds up to the event time); then 3 train
    steps from one init under remat_policy none, tri_dots and dots,
    fused_tri off and on: losses within 2e-2, ms/step, peak memory, the
    profiled step's ``aten::bmm`` count (tri_dots 2 fewer a block) and
    K4-K7's launches by route, the counters reset just before the steps
    (fused: all four wide only); before the steps, float32 K4-K7 at C = 80,
    144, 256 and 1024 on ragged N and on the step's pair rows (all four
    wide, read from the counters), and timed at the step's rows beside
    their plain versions and bounds, split by kernel (K4 and K6: the
    LayerNorm planes, then the gate GEMM); (f) TrFold with
    4-expert MoE blocks at the ``[mfu-fused]`` width, f32, B=1, L=128, card
    against CPU from one init: loss, aux, every gradient leaf;
22. model parallelism inside FoldModel: (a) ``fused_triangle_multiplication``
    on row blocks (a row mask and the column mask, as a sharded model's
    rank calls it) against the square launch, outgoing and incoming, f32
    and bf16, C = 64 and 128, L = 37 and 300 in 2-4 blocks, under a
    row-local contraction: K4's a/b, K6's rows and the pair's cotangent
    rows (K5 + K7) bitwise, the weight gradients summed over the blocks
    within K5's and K7's budgets; (b) FoldModel at fold_loo's width sharded
    over a one-rank NCCL ``(1, 1, 1)`` mesh against the unsharded model on
    phase 12's batch (K3 featurizes the crop, ``shard_feats`` keeps the
    rank's block): loss 1e-5 relative, every gradient leaf within 1e-4 of
    its largest plus 1e-6 of the model's, one optimizer step and the
    sharded optimizer state gathered and cut back; K3, K4-K7 and K8/K9's
    counters reset just before and grown after; featurize + loss +
    backward of each model timed in turns; (c) MoE under
    ``moe_param_shardings`` over dp on that group against the unsharded
    layer: output, aux, gradients (1e-5).
23. the host layer: (a) the C++ scanner (g++ at first use) against the
    NumPy scanner on every bundled PDB (its counter up by one a file, every
    field equal, coordinates bitwise), then bench.py's ``[ingest]`` (3
    passes) and ``[ingest-sustained]`` (50 passes) lanes for each scanner and
    the dataset over the files x 10 at batch 4, delivered to the card, cold
    and warm, with the parse cache's hit rate (the host's time on the card's
    machine); (b) ``from_pdb_id`` from tests/data as the cache directory
    (``urlopen`` refuses) onto the card: K1 launched once by
    ``inter_residue_geometry(use_kernel=True)``, bitwise equal to
    ``from_pdb``'s, and the antibody form's masks; (c) ``distance_histogram``
    and ``contact_map`` on config 5's K1 ``d_cb`` (B=1024, L=1024): the counts
    exactly the CPU's on structures 0-7 and 1016-1023, every row summing to
    its valid pairs, ms and peak memory; (d) ``profile_to`` around a
    ``trace("featurize")`` span calling K1, in a child process: the trace names
    both; ``Timer.block`` waits for the card; (e) a card batch and an antibody batch saved and
    loaded back onto the card, bitwise; (f) ``examples/train_trfold`` over
    tests/data on the card, 4 steps at batch 2: finite losses, the C++
    scanner run by its dataset, s/step.
24. every width the JAX package takes: (a) K4-K7 at C = 7, 8, 24 and 40 in
    both dtypes (staged to round_up(C, 16): the resident route), bf16
    C = 200 and f32 C = 72 and 100 (the wide route), on N = 2738 and 300
    rows, and C = 24 on operands off a 16-byte boundary, each against its
    plain version, each call one launch on the route make_plan reads at
    the padded width; the whole op at C = 24 against the plain path on the
    CPU; (b) K8/K9 at dh 8, 12, 24, 48, 96 (staged) and 256 (its own
    instantiation) on the whole route, and dh 257, 320, 1000 (staged to
    384, 384, 1024), 512 and 2048 on the chunked route, f32 and bf16,
    ragged L 37 and 300 with a fully masked batch row, one launch of each a
    call on the dh's route, the lse entry at dh 24, 256 and 512; (c) TrFold
    at node 96 over 4 heads (dh 24), pair 40, fused_tri and flash, 3 steps
    against the einsum step from one init, f32 (1e-5) and bf16 (2e-2), the
    counters reset just before the kernel path's steps; (d) ``[mfu-peak]``
    (phase 21e's widths) over 8 heads (dh 256) and over 4 (dh 512, the
    chunked route) with fused_tri and flash against einsum attention, runs
    of 3 steps in the order flash, einsum, einsum, flash, the first runs'
    losses 2e-2, ms/step, peak GiB, K8/K9 launches a step (6 and 3, all on
    the dh's route); (e) K4-K7 at bf16 C = 24 on ``[mfu-fused]``'s N =
    4*512*512, then K8/K9 at ``[mfu-peak]``'s node attention at dh 256, 512
    (4 heads) and 2048 (1 head), and at its shape at dh 3072 and 4096 (1
    head), each held to its plain version on the timed inputs, then timed
    beside its plain version, bound and SDPA with the float mask, the
    kernels PyTorch picked named (and SDPA's backend; "unknown" where the
    profiler recorded no kernel, whose device time is then null), and the
    timed dh at which a plain version was faster listed.

Parity tolerances on the card: K1 bitwise against its plain version (both
round every operation once; the count of unequal entries is printed and
must be 0), and under the JAX package's limits: distance maps atol 1e-5 +
rtol 1e-5; omega, theta, phi atol 1e-4 (the largest error and the count
above 1e-5 are printed); NaN patterns identical; masks bitwise; K1's bf16
planes bit for bit its f32 planes cast to bf16.  K4-K7: the JAX package's
budgets (tests/test_tri_mul.py:49-60), f32 ``max|d| <= 2e-5 max(1,
max|ref|)``, bf16 ``max|d| <= 5e-2 max|ref|``.  Train path: bf16 losses of
the fused and unfused paths within 2e-2 relative per step; f32 within 1e-5
relative, and each gradient leaf within 1e-4 of its largest entry.  K3: bins
equal except where d_cb lies within 1e-3 A of a bin edge (counted), f32
planes within 1e-5, bf16 planes within one bf16 ulp.  K8/K9: f32 out and lse
2e-5, ds 5e-4, dq/dk/dv 5e-5, each times max(1, max|ref|)
(tests/test_flash_attn.py, BASELINE.md:31-37); bf16 2e-2 times each
output's own max|ref|, with no floor (the ratio is printed); lse held on the
rows that have keys, fully-masked rows exact zeros and their lse pinned.
K2: ``max|d| <= 1e-5 max(1, max|ref|)`` (tests/test_pallas_pairwise.py:
94-141), NaN patterns equal.  Probes: K1's tolerances.
FoldModel kernel vs plain path: loss within
1e-4 relative, each gradient leaf within 1e-3 of its largest entry.

The line before the last is one JSON object describing each kernel: its
launches on its slice's main path (K1 phase 5, with its bf16 mode's own
count from the same run and its ``d_cb``-only launch of phase 19's config 5
as ``dcb_subset``, K4-K7 phase 8, K3 and K8/K9
phase 12, K8/K9's launches a phase 20 IF train step as
``design_if_step_launches``, K3, K4-K7 and K8/K9's launches by phase 22's
sharded model as ``model_parallel_launches``, K4-K7's launches by phase
22's row-block calls alone as ``row_block_launches``, K2 phase 15, each probe site its phase 17 run, with its fastest
variant and the write-only time; K1's rectangular mode and K8/K9's lse entry
point as entries of their own, launches from phase 21 (d); K5's and K7's
float32 wide route as entries of their own, K4's and K6's too, launches
from phase 9b's one counted step; every K4-K7 entry's float32 times at C =
128 and 1024; K4-K7 at a ragged C as entries of their own, launches from
phase 24 (c)'s f32 run, times at bf16 C = 24; K8/K9 at dh 256 and on the
chunked route as entries of their own, launches from phase 24 (d)'s flash
steps over 8 and 4 heads, times at its node attention at dh 256 and 512, the
chunked entries' bound with the work counted once and their recompute
factor beside it),
largest error, card and plain times, its bound (the larger of the
bytes it must move, each input it reads once (of xyz, only the atom slots
K1 and K3 read) and each output once, over 3.35 TB/s, and its operations
over the H100 SXM peak for
their type: 989 TFLOP/s bf16, 67 TFLOP/s f32; K4-K7's float32 products as
three TF32 products at 494.7 TFLOP/s, 3xTF32) and, where one PyTorch call
computes the same function, that call's time.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

    python3 chip_smoke.py --flash-timing

runs phases 1 and 13's K8/K9 timings alone (with the device times), then
K8/K9 at ``[mfu-peak]``'s node attention at dh 256 and, where the tree has
the chunked route, at dh 512, 2048, 3072 and 4096, after the K8/K9 library's ptxas
lines, and prints no result line;

    python3 chip_smoke.py --grad-timing

runs phase 1, then K2 alone at B=256, L=512 (phase 16's inputs), CUDA-event
and torch.profiler device times beside its bound, after the K2 library's
ptxas lines, and prints no result line;

    python3 chip_smoke.py --pair-timing

runs phase 1, then K1 (six f32 maps, and its bf16 mode where the checkout
has it) and K3 (bf16 and f32 planes) at B=256, L=512, CUDA-event and
torch.profiler device times, and phase 6's featurization timing, with the
K1 and K3 libraries' ptxas lines and the store path the launch plan gives
each shape, and prints no result line;

    python3 chip_smoke.py --serve

runs phase 1, phase 12's train -> fold main path (for its checkpoint) and
phase 18, and prints no result line;

    python3 chip_smoke.py --batch-api

runs phase 1, builds K1 and runs phase 19 alone, and prints no result line;

    python3 chip_smoke.py --design

runs phase 1, builds K8/K9 and runs phase 20 alone, and prints no result line;

    python3 chip_smoke.py --scale-out

runs phase 1, builds K1, K4-K7 and K8/K9 together (K1's ptxas lines) and runs
phase 21 alone, and prints no result line;

    python3 chip_smoke.py --model-parallel

runs phase 1, builds K3, K4-K7 and K8/K9 together and runs phase 22 alone,
and prints no result line;

    python3 chip_smoke.py --host

runs phase 1, builds K1 and runs phase 23 alone, and prints no result line;

    python3 chip_smoke.py --widths

runs phase 1, builds K1, K4-K7 and K8/K9 together (K4-K7's and K8/K9's
ptxas lines) and runs phase 24 alone, and prints no result line;

    python3 chip_smoke.py --tri-timing

runs phase 1, phase 9's train-step timing (fused_tri against unfused) and its
K4-K7 timings alone (the four at C = 128 must take the resident route), then
phase 21e's K4-K7 timings at ``[mfu-peak]``'s C = 1024 with each call
split by kernel; then the same in float32: phase 9b's step and K4-K7 at C
= 128 and 1024 (all four wide; a parent tree's streamed pass timed once a
turn), K4-K7 at the FoldModel's N = 4*256*256, C = 64 (all four resident)
and phase 13's FoldModel step, with the K4-K7 library's ptxas lines, and
prints no result line.  Copied into the root of another checkout and run there, each
timing mode times that checkout's kernels (skipping what it lacks), so two
commits can be set side by side on one card (parent, change, change,
parent).
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import warnings

REPO = pathlib.Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
PDBS = ("1REX.pdb", "1ad0_DC.pdb", "4EOT.pdb")
B_FULL, L_FULL = 256, 512
WARMUP, ITERS = 2, 10
DIST_ATOL = DIST_RTOL = 1e-5
ANGLE_ATOL = 1e-4
DIST_MAPS = ("d_ca", "d_cb", "d_no")
TRAIN_WIDTH = dict(node_dim=256, pair_dim=128, n_heads=8, n_blocks=4, pair_update="triangle",
                   remat=True)  # bench.py:338-345 [mfu-fused], with fused_tri
TRAIN_STEPS = 3


def say(*parts):
    print(*parts, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def compare(ref, out, name, atol=None, rtol=0.0):
    """Max |ref - out| of one tensor pair, ``out`` brought to ``ref``'s
    device: masks bitwise, the same NaN pattern, |d| <= atol + rtol |ref|
    (without ``atol``, the map tolerance that the name's last word picks);
    returns (max_err, count above 1e-5)."""
    import torch

    out = out.detach().to(ref.device)
    check(ref.shape == out.shape, f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if ref.dtype == torch.bool:
        check(torch.equal(ref, out), f"{name}: masks differ at {int((ref != out).sum())} entries")
        return 0.0, 0
    nan_r, nan_o = torch.isnan(ref), torch.isnan(out)
    check(torch.equal(nan_r, nan_o),
          f"{name}: NaN patterns differ at {int((nan_r != nan_o).sum())} entries")
    diff = (ref - out).abs().masked_fill(nan_r, 0)
    err = float(diff.max()) if diff.numel() else 0.0
    if atol is not None:
        bad = diff > atol + rtol * ref.abs().masked_fill(nan_r, 0)
    elif name.rsplit(" ", 1)[-1] in DIST_MAPS:
        bad = diff > DIST_ATOL + DIST_RTOL * ref.abs().masked_fill(nan_r, 0)
    else:
        bad = diff > ANGLE_ATOL
    check(not bool(bad.any()), f"{name}: {int(bad.sum())} entries out of tolerance, max {err:.3e}")
    return err, int((diff > 1e-5).sum())


def compare_maps(ref, out, label):
    worst = 0.0
    parts = []
    for k in ref:
        err, n_above = compare(ref[k], out[k], f"{label} {k}")
        worst = max(worst, err)
        parts.append(f"{k} {err:.2e}" + (f" ({n_above} > 1e-5)" if n_above else ""))
    say(f"  {label}: " + ", ".join(parts))
    return worst


PAIR_LENGTHS = (1, 2, 31, 33, 37, 127, 129, 300, 512)   # the tile walk's edges, ragged and whole


def unequal(ref, out):
    """Entries of ``out`` whose bits differ from ``ref``'s (NaN equal to NaN)."""
    import torch

    check(ref.shape == out.shape and ref.dtype == out.dtype,
          f"{tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    nan_r, nan_o = torch.isnan(ref), torch.isnan(out)
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[ref.dtype]
    differ = ref.masked_fill(nan_r, 0).view(view) != out.masked_fill(nan_o, 0).view(view)
    return int((differ | (nan_r != nan_o)).sum())


def k1_bitwise(ref, out, label):
    """K1's maps against the plain version's, bit for bit; returns the count."""
    n = {k: unequal(ref[k], out[k]) for k in ref}
    check(sum(n.values()) == 0, f"{label}: K1 differs from its plain version at {n} entries")
    return sum(n.values())


def k1_bf16_gate(torch, pair_maps, x, label):
    """K1's bf16 mode against its own f32 planes cast to bf16, bit for bit."""
    f32 = pair_maps.pairwise_maps_forward(x)
    b16 = pair_maps.pairwise_maps_forward(x, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = {k: unequal(f32[k].to(torch.bfloat16), b16[k]) for k in f32}
    check(sum(n.values()) == 0, f"{label}: K1 bf16 differs from its f32 planes cast at {n} entries")
    return sum(n.values())


def k1_subset_writes(torch, pair_maps, x, maps, dtype):
    """K1 through its C entry with all six planes filled with a sentinel and
    ``maps`` selected: the selected planes equal the wrapper's, the others
    keep every sentinel bit."""
    B, L, A, _ = x.shape
    lib = pair_maps.load_library()
    fn = lib.ps_pair_maps_f32 if dtype == torch.float32 else lib.ps_pair_maps_bf16
    planes = {k: torch.full((B, L, L), 7.0, dtype=dtype, device=x.device) for k in pair_maps.MAP_NAMES}
    bits = sum(1 << pair_maps.MAP_NAMES.index(k) for k in maps)
    err = fn(x.device.index, x.data_ptr(), B, L, A, bits, *[planes[k].data_ptr() for k in pair_maps.MAP_NAMES],
             pair_maps.plan_arg(pair_maps.tile_plan(B, L)), torch.cuda.current_stream(x.device).cuda_stream)
    check(err == 0, f"K1 subset launch: CUDA error {err}")
    want = pair_maps.pairwise_maps_forward(x, maps, out_dtype=dtype)
    torch.cuda.synchronize()
    for k, p in planes.items():
        if k in maps:
            check(unequal(want[k], p) == 0, f"K1 subset {dtype}: {k} differs from the wrapper's")
        else:
            check(bool((p == 7.0).all()), f"K1 subset {dtype}: unselected {k} was written")


def cuda_time_ms(fn):
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def alternate(plain, kernel):
    """Time plain, kernel, kernel, plain; returns the mean ms of each."""
    p1, k1, k2, p2 = cuda_time_ms(plain), cuda_time_ms(kernel), cuda_time_ms(kernel), cuda_time_ms(plain)
    return (p1 + p2) / 2, (k1 + k2) / 2, (p1, k1, k2, p2)


def probes(torch, device):
    """Degenerate configurations: pinned, NaN, padding, and shared atoms."""
    import numpy as np

    xyz = (np.random.RandomState(2).randn(1, 40, 15, 3) * 5).astype(np.float32)
    xyz[0, 3, 4] = xyz[0, 3, 1]          # CB == CA in one residue
    xyz[0, 5] = xyz[0, 9]                # a residue duplicated
    xyz[0, 7, 0] = xyz[0, 7, 1]          # N == CA
    xyz[0, 8, 4:] = np.nan               # GLY: no CB
    xyz[0, 12] = xyz[0, 12, 1]           # a collapsed residue
    xyz[0, 14, 4] = xyz[0, 15, 4]        # two residues share a CB
    xyz[0, 16, 1] = xyz[0, 17, 1]        # two residues share a CA
    xyz[0, 18, 1] = xyz[0, 19, 4]        # CA_i == CB_j
    xyz[0, 32:] = 0.0                    # zero-coordinate padding
    return torch.from_numpy(xyz).to(device)


TRI_KERNELS = ("prologue_fwd", "prologue_bwd", "epilogue_fwd", "epilogue_bwd")
TRI_REPLACES = {"prologue_fwd": "protstruc_tpu/ops/tri_mul.py:107",
                "prologue_bwd": "protstruc_tpu/ops/tri_mul.py:121",
                "epilogue_fwd": "protstruc_tpu/ops/tri_mul.py:267",
                "epilogue_bwd": "protstruc_tpu/ops/tri_mul.py:279"}
TRI_OUTPUTS = {
    "prologue_fwd": ("a", "b"),
    "prologue_bwd": ("dx", "d_lns", "d_lnb", "d_wag", "d_bag", "d_wap", "d_bap",
                     "d_wbg", "d_bbg", "d_wbp", "d_bbp"),
    "epilogue_fwd": ("out",),
    "epilogue_bwd": ("dx", "dp", "d_ln1s", "d_ln1b", "d_wog", "d_bog", "d_ln2s",
                     "d_ln2b", "d_wo", "d_bo"),
}


def tri_budget(torch, ref, out, name):
    """The JAX package's tri_mul budgets (tests/test_tri_mul.py:49-60): f32
    max|d| <= 2e-5 max(1, max|ref|); bf16 max|d| / max|ref| <= 5e-2.
    Returns (max|d|, max|d| / max|ref|)."""
    check(ref.shape == out.shape and ref.dtype == out.dtype,
          f"{name}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    r, o = ref.float(), out.float()
    check(bool(torch.isfinite(o).all()), f"{name}: non-finite output")
    err = float((r - o).abs().max()) if r.numel() else 0.0
    scale = float(r.abs().max()) if r.numel() else 0.0
    if ref.dtype == torch.float32:
        check(err <= 2e-5 * max(1.0, scale), f"{name}: max err {err:.3e} > 2e-5 * max(1, {scale:.3e})")
    else:
        check(err <= 5e-2 * max(scale, 1e-3), f"{name}: max err {err:.3e} > 5e-2 * {scale:.3e}")
    return err, err / scale if scale else 0.0


def tri_inputs(torch, dev, dtype, C, B=2, L=37, seed=0):
    """Random pair rows (N = B*L*L, ragged against every tile) with masked
    residues, product rows, cotangents and weights, drawn on the card from a
    generator seeded with `seed`."""
    gen = torch.Generator(dev).manual_seed(seed)
    N = B * L * L

    def t(*shape, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    mask = torch.ones((B, L), dtype=torch.bool, device=dev)
    mask[B - 1, L - 5:] = False
    mask[0, 3] = False
    m = (mask[:, :, None] & mask[:, None, :]).reshape(N).to(dtype)
    x, p = t(N, C, shift=0.3), t(N, C, scale=3.0)
    ln = lambda: (t(C, scale=0.2, shift=1.0), t(C, scale=0.2))  # noqa: E731
    lin = lambda: (t(C, C, scale=C ** -0.5), t(C, scale=0.1))   # noqa: E731
    pro_w = [*ln(), *lin(), *lin(), *lin(), *lin()]
    epi_w = [*pro_w[:2], *lin(), *ln(), *lin()]
    return {
        "prologue_fwd": (x, m, *pro_w),
        "prologue_bwd": (x, m, *pro_w, t(N, C), t(N, C)),
        "epilogue_fwd": (x, p, *epi_w),
        "epilogue_bwd": (x, p, *epi_w, t(N, C)),
        "mask": mask,
    }


def tri_kernel_vs_plain(torch, tri_mul, name, args, label):
    """One of K4-K7 and its plain version on the same card tensors, every
    output under tri_budget; prints each output's error (and its ratio to the
    output's largest value), returns the largest error."""
    kernel, plain = tri_mul.KERNELS[name]
    got = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    check(len(got) == len(ref) == len(TRI_OUTPUTS[name]), f"{name}: {len(got)} outputs")
    errs = [tri_budget(torch, r, o, f"{name} {label} {k}")
            for k, r, o in zip(TRI_OUTPUTS[name], ref, got)]
    say(f"  {name} {label} N={args[0].shape[0]}: "
        + ", ".join(f"{k} {e:.2e} ({r:.1e})" for k, (e, r) in zip(TRI_OUTPUTS[name], errs)))
    return max(e for e, _ in errs)


def tri_kernel_parity(torch, dev):
    """K4-K7 against their plain versions on the card, each output compared.
    Returns the largest error of each kernel over all cases."""
    from protstruc_tpu_torch.ops import tri_mul

    worst = {k: 0.0 for k in TRI_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        for C, B, L in ((16, 2, 37), (64, 2, 37), (128, 2, 37), (128, 1, 160), (256, 2, 37)):
            cases = tri_inputs(torch, dev, dtype, C, B=B, L=L)
            for name in TRI_KERNELS:
                err = tri_kernel_vs_plain(torch, tri_mul, name, cases[name],
                                          f"{str(dtype)[6:]} C={C}")
                worst[name] = max(worst[name], err)
            # the whole op, forward and backward, outgoing and incoming, against
            # the plain path on the CPU
            x = cases["prologue_fwd"][0]
            w = cases["epilogue_fwd"][2:]
            params = {"ln_in": w[0:2], "out_gate": w[2:4], "ln_out": w[4:6], "out_proj": w[6:8],
                      "a_gate": cases["prologue_fwd"][4:6], "a_proj": cases["prologue_fwd"][6:8],
                      "b_gate": cases["prologue_fwd"][8:10], "b_proj": cases["prologue_fwd"][10:12]}
            pair = x.reshape(B, L, L, C)
            mask = cases["mask"]
            ct = cases["epilogue_bwd"][-1].reshape(pair.shape)
            for outgoing in (True, False):
                outs = []
                for d in (dev, torch.device("cpu")):
                    leaves = [pair.detach().to(d).requires_grad_()] + [
                        v.detach().to(d).requires_grad_() for pair_ in params.values() for v in pair_]
                    it = iter(leaves[1:])
                    prm = {k: (next(it), next(it)) for k in params}
                    y = tri_mul.fused_triangle_multiplication(leaves[0], mask.to(d), prm, outgoing)
                    grads = torch.autograd.grad(y, leaves, ct.to(d))
                    outs.append([y.detach().cpu()] + [g.cpu() for g in grads])
                torch.cuda.synchronize()
                errs = [tri_budget(torch, r, o, f"op outgoing={outgoing} {dtype} C={C} L={L} #{i}")[0]
                        for i, (o, r) in enumerate(zip(*outs))]
                say(f"  fused_triangle_multiplication {str(dtype)[6:]} C={C} L={L} outgoing={outgoing}: "
                    f"out {errs[0]:.2e}, grads max {max(errs[1:]):.2e} over {len(errs) - 1} leaves")
        if dtype == torch.float32:
            # the FoldModel's pair rows (fold_loo.py: B 4, crop 256, C 64), where
            # each warp of the resident passes (K4-K7) walks many tiles
            # through its ring and the weight-gradient pass sums many row steps
            cases = tri_inputs(torch, dev, dtype, 64, B=4, L=256)
            for name in TRI_KERNELS:
                err = tri_kernel_vs_plain(torch, tri_mul, name, cases[name], "float32 C=64 FoldModel shape")
                worst[name] = max(worst[name], err)
            del cases
        # K4-K7 on tensors (rows, weights, cotangents) that start one element
        # past a 16-byte boundary (their wrappers hand the kernels aligned
        # copies)
        for name in TRI_KERNELS:
            args = [off_alignment(torch, t) for t in tri_inputs(torch, dev, dtype, 64)[name]]
            check(all(t.data_ptr() % 16 for t in args), "the offset copies are aligned")
            err = tri_kernel_vs_plain(torch, tri_mul, name, args, f"{str(dtype)[6:]} C=64 off alignment")
            worst[name] = max(worst[name], err)
    return worst


def off_alignment(torch, t):
    """A copy of ``t`` whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16 // t.element_size(), dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def build_all(cuda_lib, pair_maps, tri_mul, model_features, flash_attn, kernel_probe):
    """Build K1, K2, K3, K4-K7, K8/K9 and the K1 probes at once (one nvcc
    each, started together); returns {library: (path, built or loaded,
    seconds)}."""
    libs = {"pair_maps": (pair_maps.load_library, cuda_lib.library_path("pair_maps", pair_maps._SOURCES)),
            "pair_maps_bwd": (pair_maps.load_bwd_library, pair_maps.bwd_library_path()),
            "pair_maps_probe": (kernel_probe.load_library, kernel_probe.library_path()),
            "tri_mul": (tri_mul.load_library, tri_mul.library_path()),
            "model_features": (model_features.load_library, model_features.library_path()),
            "flash_attn": (flash_attn.load_library, flash_attn.library_path())}

    def one(item):
        name, (load, path) = item
        prebuilt = path.is_file()
        t0 = time.perf_counter()
        load()
        return name, (path, "loaded prebuilt" if prebuilt else "built", time.perf_counter() - t0)

    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:
        return dict(ex.map(one, libs.items()))


K3_EDGE = 1e-3   # bins may differ only where d_cb lies this close to a bin edge (angstroms)


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (the spacing of bf16 values around it), taken at
    1e-4 for smaller values, as in tests/test_torch_model_features.py."""
    a = x.float().abs().clamp_min(1e-4)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def store_path(L):
    """The stores the launch plan hands K1 and K3 at length L (the wrappers
    pass ``tile_plan``'s store rule to every launch; a parent tree without
    the plan stored every pair by itself)."""
    from protstruc_tpu_torch.ops import pair_maps

    if not hasattr(pair_maps, "plan_arg"):
        return "4-byte scalar (32x8 block)"
    return f"{'vector' if pair_maps.tile_plan(1, L).vector else 'scalar'} (launch plan)"


def featurize_timing(torch, xyz, smi, k1_ms):
    """Phase 6's full featurization of ``xyz`` (``utils/aot._featurize``),
    kernel path against plain path, CUDA events, and each path's peak; then
    the kernel path's device time under torch.profiler (the event time also
    reads the host's launch rate)."""
    from protstruc_tpu_torch.utils.aot import _featurize

    B, L = xyz.shape[:2]
    am = torch.ones((B, L, 15), dtype=torch.bool, device=xyz.device)
    ci = torch.zeros((B, L), dtype=torch.int32, device=xyz.device)
    peak = {}

    def run(use_kernel):
        def fn():
            with torch.inference_mode():
                _featurize(xyz, am, ci, use_kernel)
        return fn

    for name, use_kernel in (("kernel", True), ("plain", False)):
        torch.cuda.reset_peak_memory_stats()
        run(use_kernel)()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    feat_plain, feat_kernel, rounds = alternate(run(False), run(True))
    dev_kernel, names = device_ms(torch, run(True))
    say(f"phase 6 timing featurize B={B} L={L} [{smi}]: "
        f"kernel path {feat_kernel:.4f} ms = {B / feat_kernel * 1e3:.1f} structures/s "
        f"(peak {peak['kernel']:.2f} GiB), plain path {feat_plain:.4f} ms = "
        f"{B / feat_plain * 1e3:.1f} structures/s (peak {peak['plain']:.2f} GiB) "
        f"(plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)}); "
        f"K1 writes {B * L * L * 24 / k1_ms / 1e6:.1f} GB/s of maps; kernel path device time "
        f"{fmt_ms(dev_kernel)} a call (torch.profiler; largest {kernel_name(names[0]) if names else 'none'})")
    return feat_kernel


def pair_timing(torch, dev, smi):
    """``--pair-timing``: K1 (f32, and bf16 where the checkout has the mode)
    and K3 (bf16 and f32 planes) at B=256, L=512, CUDA-event and profiler
    device times, then phase 6's featurization, in whatever checkout holds
    this script."""
    import numpy as np
    from protstruc_tpu_torch.ops import cuda_lib, model_features as mf, pair_maps as pm

    t0 = time.perf_counter()
    pm.load_library()
    mf.load_library()
    say(f"pair timing of {REPO}: K1 and K3 built or loaded in {time.perf_counter() - t0:.2f} s")
    for name, path in (("K1", cuda_lib.library_path("pair_maps", pm._SOURCES)), ("K3", mf.library_path())):
        for ln in cuda_lib.ptxas_lines(path.with_suffix(".log")):
            say(f"  ptxas {name}: {ln}")
    xyz = torch.from_numpy(np.random.RandomState(0).randn(B_FULL, L_FULL, 15, 3).astype(np.float32) * 10).to(dev)
    pairs = B_FULL * L_FULL ** 2
    cases = [("K1 f32 six maps", lambda: pm.pairwise_maps(xyz), slot_bytes(xyz, K1_SLOTS) + pairs * 24,
              K1_OPS_PER_PAIR)]
    if hasattr(pm, "pairwise_maps_forward"):
        cases.append(("K1 bf16 six maps", lambda: pm.pairwise_maps_forward(xyz, out_dtype=torch.bfloat16),
                      slot_bytes(xyz, K1_SLOTS) + pairs * 12, K1_OPS_PER_PAIR))
    for dt, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        cases.append((f"K3 {str(dt)[6:]} planes", lambda dt=dt: mf.model_features(xyz, 36, 20.0, dt),
                      slot_bytes(xyz, K3_SLOTS) + pairs * (4 + 6 * size), K3_OPS_PER_PAIR))
    k1_ms = None
    for name, fn, n_bytes, ops in cases:
        ev = cuda_time_ms(fn)
        dv, names = device_ms(torch, fn)
        k1_ms = k1_ms or ev
        b_ms, b_by = bound(n_bytes, ops * pairs, torch.float32)
        say(f"pair timing {name} B={B_FULL} L={L_FULL} [{smi}]: event {ev:.4f} ms, device {fmt_ms(dv)} "
            f"({kernel_name(names[0]) if names else 'no kernel'}); bound {b_ms:.4f} ms ({b_by}); "
            f"{store_path(L_FULL)} stores")
    featurize_timing(torch, xyz, smi, k1_ms)


def k3_compare(torch, mf, x, label, n_bins=36, max_dist=20.0):
    """K3 against its plain version on the same card tensor, f32 and bf16
    planes; returns (largest plane error, bin mismatches, pairs near an edge)."""
    worst, mismatches, near_edge = 0.0, 0, 0
    cb = x[:, :, 4]
    d = torch.sqrt(((cb[:, :, None] - cb[:, None]) ** 2).sum(-1))
    width = max_dist / n_bins
    edge_dist = (d / width - torch.round(d / width)).abs() * width
    near = edge_dist < K3_EDGE
    for dt in (torch.float32, torch.bfloat16):
        bins, ang = mf.model_features(x, n_bins, max_dist, dt)
        torch.cuda.synchronize()
        rbins, rang = mf._model_features_plain(x, n_bins, max_dist, dt)
        check(bins.shape == rbins.shape and ang.shape == rang.shape and ang.dtype == dt,
              f"K3 {label}: shapes {tuple(bins.shape)} {tuple(ang.shape)} {ang.dtype}")
        off = bins != rbins
        check(not bool((off & ~near).any()),
              f"K3 {label} {dt}: {int((off & ~near).sum())} bins differ away from an edge")
        mismatches = max(mismatches, int(off.sum()))
        diff = (ang.float() - rang.float()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if dt == torch.float32:
            check(err <= 1e-5, f"K3 {label} f32 planes: max err {err:.3e} > 1e-5")
        else:
            over = diff > bf16_ulp(torch, rang)
            check(not bool(over.any()), f"K3 {label} bf16 planes: {int(over.sum())} entries "
                  f"beyond one bf16 ulp, max err {err:.3e}")
        worst = max(worst, err)
    near_edge = int(near.sum())
    say(f"  K3 {label} B={x.shape[0]} L={x.shape[1]} ({store_path(x.shape[1])} stores): planes max err "
        f"{worst:.2e}; bins differ at "
        f"{mismatches} pairs (all within {K3_EDGE} A of an edge; {near_edge} pairs that close)")
    return worst, mismatches, near_edge


def k3_parity(torch, dev):
    """Phase 10: K3 vs its plain version at every L of PAIR_LENGTHS (B=2), the
    degenerate probes and the [model-fused] shape B=256, L=512 (in chunks for
    the plain version)."""
    import numpy as np
    from protstruc_tpu_torch.ops import model_features as mf

    rng = np.random.RandomState(1)
    cases = {f"L{L}": torch.from_numpy((rng.randn(2, L, 15, 3) * 10).astype(np.float32)).to(dev)
             for L in (37, 300)}
    rng = np.random.RandomState(5)
    cases.update({f"L{L}": torch.from_numpy((rng.randn(2, L, 15, 3) * 10).astype(np.float32)).to(dev)
                  for L in PAIR_LENGTHS if f"L{L}" not in cases})
    cases["probes"] = probes(torch, dev)
    worst, total_mis = 0.0, 0
    for label, x in cases.items():
        err, mis, _ = k3_compare(torch, mf, x, label)
        worst, total_mis = max(worst, err), total_mis + mis
    xyz = torch.from_numpy(np.random.RandomState(0).randn(B_FULL, L_FULL, 15, 3).astype(np.float32) * 10).to(dev)
    for b0 in range(0, B_FULL, 64):
        err, mis, _ = k3_compare(torch, mf, xyz[b0:b0 + 64].contiguous(), f"full[{b0}:{b0 + 64}]")
        worst, total_mis = max(worst, err), total_mis + mis
    return worst, total_mis


FLASH_SHAPES = (  # (label, B, H, dh, L, dtypes: None for both, else the one)
    ("train", 4, 4, 32, 256, None),          # the FoldModel train step's node attention
    ("train-contig", 4, 4, 32, 256, None),   # the same with a contiguous bias
    ("ragged", 2, 4, 32, 37, None),          # batch row 1 fully masked
    ("ragged", 2, 4, 32, 300, None),
    ("ragged", 1, 2, 32, 17, None),          # shorter than one 64-row block
    ("unaligned", 2, 4, 32, 70, None),       # q/k/v rows off 16-byte alignment
    ("gate", 1, 2, 16, 96, None),            # bench.py:977-997: last 8 keys masked
    ("gate", 1, 2, 64, 96, None),
    ("gate", 1, 2, 128, 96, None),
    ("wide", 1, 1, 128, 2048, "bfloat16"),   # bench.py:1003-1012
    ("attn", 1, 8, 32, 4096, None),          # bench.py [attn]: last 100 keys masked
    ("many", 16400, 4, 16, 17, "float32"),   # B*H = 65600 blocks along grid x
)


def flash_inputs(torch, dev, dtype, label, B, H, dh, L, seed=0):
    """q, k, v as views of one (B, L, 3, H, dh) projection, bias, kmask and
    the output cotangent, drawn on the card.  The train shape's bias is the
    permuted (B, L, L, H) layout the model passes; the others are contiguous.
    ``unaligned`` starts the projection one element into its buffer."""
    gen = torch.Generator(dev).manual_seed(seed)
    off = 1 if label == "unaligned" else 0
    qkv = torch.randn((B * L * 3 * H * dh + off,), generator=gen, device=dev).to(dtype)
    qkv = qkv[off:].view(B, L, 3, H, dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if label == "train":
        bias = torch.randn((B, L, L, H), generator=gen, device=dev).to(dtype).permute(0, 3, 1, 2)
    else:
        bias = torch.randn((B, H, L, L), generator=gen, device=dev).to(dtype)
    kmask = torch.ones((B, L), dtype=torch.bool, device=dev)
    if label == "ragged":
        kmask[0, L // 3] = False
        kmask[0, -3:] = False
        if B > 1:
            kmask[1] = False
    elif label == "attn":
        kmask[:, -100:] = False
    elif label == "gate":
        kmask[:, -8:] = False
    elif label == "many":
        kmask[::3, -2:] = False
    do = torch.randn((B, L, H, dh), generator=gen, device=dev).to(dtype)
    return q, k, v, bias, kmask, do


# f32 budgets (tests/test_flash_attn.py, BASELINE.md:31-37), times max(1, max|ref|);
# bf16 outputs: 2e-2 of the output's own max|ref| (test_bfloat16_inputs' atol,
# without the floor of 1, which would pass a zero ds: |ds| is ~1e-3 at [attn])
FLASH_F32 = {"out": 2e-5, "lse": 2e-5, "ds": 5e-4, "dq": 5e-5, "dk": 5e-5, "dv": 5e-5}
FLASH_BF16 = 2e-2


def flash_budget(torch, ref, out, name, key, live=None):
    """The largest error of ``out`` against ``ref`` over the entries ``live``
    selects (all by default), held to its budget; returns (error, error over
    max|ref|)."""
    check(ref.shape == out.shape and ref.dtype == out.dtype,
          f"{name}: {tuple(out.shape)} {out.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    r, o = (ref.float(), out.float()) if live is None else (ref.float()[live], out.float()[live])
    err = float((r - o).abs().max()) if r.numel() else 0.0
    top = float(r.abs().max()) if r.numel() else 0.0
    if out.dtype == torch.float32:
        tol = FLASH_F32[key] * max(1.0, top)
    else:
        tol = FLASH_BF16 * top
    check(err <= tol, f"{name}: max err {err:.3e} > {tol:.3e} (max|ref| {top:.3e})")
    return err, err / max(top, 1e-30)


def flash_vs_plain(torch, fa, args, label):
    """K8 and K9 against their plain versions on the same card tensors (K9
    from the plain forward's lse and delta), plus dq = ds k from each ds;
    fully-masked rows must be exact zeros.  Returns {fwd, bwd: max error}."""
    q, k, v, bias, kmask, do = args
    out, lse = fa.flash_fwd(q, k, v, bias, kmask)
    torch.cuda.synchronize()
    r_out, r_lse = fa._flash_fwd_plain(q, k, v, bias, kmask)
    delta = (do.float() * r_out.float()).sum(-1).permute(0, 2, 1).contiguous()
    got = fa.flash_bwd(q, k, v, bias, kmask, do, r_lse, delta)
    torch.cuda.synchronize()
    ref = fa._flash_bwd_plain(q, k, v, bias, kmask, do, r_lse, delta)
    got = {"out": out, "lse": lse, "ds": got[0], "dk": got[1], "dv": got[2],
           "dq": fa.dq_from_ds(got[0], k)}
    ref = {"out": r_out, "lse": r_lse, "ds": ref[0], "dk": ref[1], "dv": ref[2],
           "dq": fa.dq_from_ds(ref[0], k)}
    dead = ~kmask.any(-1)
    live_rows = (~dead)[:, None, None].expand_as(ref["lse"])  # the pinned lse is checked below
    errs = {key: flash_budget(torch, ref[key], got[key], f"flash {label} {key}", key,
                              live_rows if key == "lse" else None) for key in got}
    if bool(dead.any()):
        for key in ("out", "dq", "dk", "dv"):
            check(bool((got[key][dead] == 0).all()), f"flash {label}: {key} of a fully-masked row not 0")
        check(bool((got["ds"][dead] == 0).all()), f"flash {label}: ds of a fully-masked row not 0")
        check(bool((got["lse"][dead] == fa.LSE_MASKED).all()), f"flash {label}: lse pin")
    say(f"  flash {label}: " + ", ".join(f"{key} {e:.2e} ({rel:.2e} of max|ref|)"
                                         for key, (e, rel) in errs.items()))
    return {"fwd": max(errs["out"][0], errs["lse"][0]),
            "bwd": max(errs[key][0] for key in ("ds", "dk", "dv", "dq"))}


def flash_parity(torch, dev):
    """Phase 11: K8/K9 vs their plain versions, f32 and bf16, at every shape."""
    from protstruc_tpu_torch.ops import flash_attn as fa

    worst = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, H, dh, L, only in FLASH_SHAPES:
            if only is not None and str(dtype) != f"torch.{only}":
                continue
            args = flash_inputs(torch, dev, dtype, label, B, H, dh, L)
            errs = flash_vs_plain(torch, fa, args, f"{label} {str(dtype)[6:]} B={B} H={H} dh={dh} L={L}")
            for key in worst:
                worst[key] = max(worst[key], errs[key])
            del args
            torch.cuda.empty_cache()
    return worst


def zero_grad_entries(torch, key, g):
    """Entries whose exact gradient is 0, where both paths return rounding
    noise: the pair-bias biases (trunk and IPA) and the key biases (``qkv``'s
    key third, IPA's ``k_scalar``) each add a per-head constant to every logit
    of a softmax row; and at the FoldModel's init (zero backbone-update
    kernel, so every residue's frame moves alike) the backbone update's bias
    is one rigid motion of the whole chain, which FAPE, lDDT and IPA do not
    see."""
    mask = torch.zeros_like(g, dtype=torch.bool)
    if key.endswith(("attn.pair_bias.bias", "ipa.pair_bias.bias", "ipa.k_scalar.bias",
                     "backbone_update.update.bias")):
        mask[...] = True
    elif key.endswith("attn.qkv.bias"):
        mask[1] = True
    return mask


def grad_error(torch, ref, got):
    """The largest error of ``got`` against ``ref`` (gradients by name) over
    each leaf's largest entry, as ``(leaf, ratio)``; the exact-zero entries of
    zero_grad_entries must stay within 1e-5 of the largest gradient."""
    worst_leaf, worst_rel = None, 0.0
    top = max(float(g.abs().max()) for g in ref.values())
    for k, r in ref.items():
        g, zero = got[k], zero_grad_entries(torch, k, r)
        if zero.any():
            noise = max(float(g[zero].abs().max()), float(r[zero].abs().max()))
            check(noise <= 1e-5 * top, f"{k}: zero-gradient entries {noise:.3e} vs top {top:.3e}")
        if zero.all():
            continue
        rel = float((g - r)[~zero].abs().max()) / max(float(r[~zero].abs().max()), 1e-30)
        if rel > worst_rel:
            worst_leaf, worst_rel = k, rel
    return worst_leaf, worst_rel


def train_models(torch, dev, cfg_kwargs, xyz_np):
    """Featurize ``xyz_np`` on the card through K1, then a fused and an unfused
    TrFold from one seeded init; returns (feats, {fused: (model, params,
    opt_state, tx)}, the initial state_dict)."""
    return seeded_models(torch, dev, cfg_kwargs, xyz_np, {True: dict(fused_tri=True),
                                                         False: dict(fused_tri=False)})


def seeded_models(torch, dev, cfg_kwargs, xyz_np, variants):
    """TrFold models from one seeded init, one for each of ``variants``
    ({label: TrFoldConfig overrides}), on features of ``xyz_np`` (K1);
    returns (feats, {label: (model, params, opt_state, tx)}, the initial
    state_dict)."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.models.trfold import (
        TrFold, TrFoldConfig, featurize_for_model, make_train_state)

    sb = pt.StructureBatch.from_xyz(xyz_np, device=dev)
    feats = featurize_for_model(sb, use_kernel=True)
    models, init = {}, None
    for label, over in variants.items():
        model = TrFold(TrFoldConfig(**cfg_kwargs, **over), device=dev)
        state = make_train_state(model, feats, torch.Generator().manual_seed(0), device=dev)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        models[label] = (model, *state)
    return feats, models, init


def train_xyz(np):
    """The train path's coordinates: ``randn(4, 512, 15, 3) * 5``, numpy seed 0
    (bench.py:370-373)."""
    return np.random.RandomState(0).randn(4, L_FULL, 15, 3).astype(np.float32) * 5.0


def run_steps(feats, entry, n):
    """``n`` train steps of one (model, params, opt_state, tx); their losses."""
    from protstruc_tpu_torch.models.trfold import train_step

    model, params, opt_state, tx = entry
    losses = []
    for _ in range(n):
        params, opt_state, loss = train_step(params, opt_state, feats, model, tx)
        losses.append(float(loss))
    return losses


def compare_losses(fused, plain, rtol, label):
    for i, (a, b) in enumerate(zip(fused, plain)):
        check(abs(a - b) <= rtol * abs(b), f"{label} step {i}: fused loss {a!r} vs unfused {b!r}")


def train_step_timing(torch, smi, models, feats, init, label="phase 9", dtype="bf16", loss_rtol=None):
    """Phase 9's train step at the ``[mfu-fused]`` width, fused_tri against
    unfused, in turns; prints ms/step and peak memory, then one step of each
    under torch.profiler (device busy, the top kernels).  Three steps already
    moved the parameters far from the init (the loss grows), so every timed
    step starts again from the initial parameters: each times the same
    workload, on sound values.  With ``loss_rtol`` the fused step's losses
    must lie within it, relative, of the unfused step's.  Returns {fused:
    (ms/step, peak GiB, device busy ms of the profiled step)}."""
    from protstruc_tpu_torch.models.trfold import train_step

    step_ms, peak, step_losses = {}, {}, {True: [], False: []}

    def stepper(fused):
        model, params, opt_state, tx = models[fused]
        state = model.state_dict()
        leaves = [(state[k], v) for k, v in init.items()]

        def step():
            with torch.no_grad():
                for leaf, v in leaves:
                    leaf.copy_(v)
            step_losses[fused].append(train_step(params, opt_state, feats, model, tx)[2])
        return step

    for fused in (True, False):
        torch.cuda.reset_peak_memory_stats()
        stepper(fused)()
        torch.cuda.synchronize()
        peak[fused] = torch.cuda.max_memory_allocated() / 2**30
    step_ms[False], step_ms[True], rounds = alternate(stepper(False), stepper(True))
    profiles, busy_ms = [], {}
    for fused in (True, False):
        wall, busy, top = device_profile(torch, stepper(fused), top=8)
        busy_ms[fused] = busy
        profiles.append(
            f"{label} profile train step {dtype}, fused_tri={fused}, one step under torch.profiler: device busy "
            f"{busy:.2f} of {wall:.2f} ms wall (idle {100 * (1 - busy / wall):.1f}%); top kernels "
            + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in top))
    for fused, losses in step_losses.items():
        losses = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(losses).all()), f"timed steps fused_tri={fused}: losses {losses}")
        step_losses[fused] = (float(losses.min()), float(losses.max()), len(losses))
    if loss_rtol is not None:
        for f, u in zip(step_losses[True][:2], step_losses[False][:2]):
            check(abs(f - u) <= loss_rtol * abs(u),
                  f"{label} {dtype}: fused loss {f!r} vs unfused {u!r}, past {loss_rtol} relative")
    say(f"{label} timing train step {dtype} B=4 L={L_FULL} [{smi}]: fused_tri {step_ms[True]:.4f} ms/step "
        f"(peak {peak[True]:.2f} GiB), unfused {step_ms[False]:.4f} ms/step (peak {peak[False]:.2f} GiB) "
        f"(unfused/fused/fused/unfused {', '.join(f'{r:.4f}' for r in rounds)}); each step from the "
        f"initial parameters, losses (min, max, steps) fused {step_losses[True]}, "
        f"unfused {step_losses[False]}")
    for line in profiles:
        say(line)
    return {f: (step_ms[f], peak[f], busy_ms[f]) for f in (True, False)}


def tri_route(tri_mul, name, x):
    """The route ``name`` takes on ``x`` in this checkout ("streamed" in a
    tree before the route query)."""
    return tri_mul.route(name, x) if hasattr(tri_mul, "route") else "streamed"


def f32_wide_tree(torch, dev, tri_mul):
    """Whether this checkout's K5 and K7 take the wide route in float32 above
    C = 64 (a parent tree, timed against this one, takes their streamed
    passes there)."""
    x = torch.empty((0, 128), dtype=torch.float32, device=dev)
    return all(tri_route(tri_mul, name, x) == "wide" for name in ("prologue_bwd", "epilogue_bwd"))


def expected_tri_route(dtype, C):
    """make_plan's route table (csrc/tri_mul.cu): resident at bf16 C <= 128 and
    float32 C <= 64; wide above the resident widths, both dtypes, all four
    kernels."""
    import torch

    return "resident" if C <= (128 if dtype == torch.bfloat16 else 64) else "wide"


def tri_timings(torch, dev, smi, tri_worst, dtype=None, C=128, L=None, phase=None):
    """Phase 9's K4-K7 at the train path's shape (N = 4*512*512, C = 128;
    bf16: all four resident; phase 9b's float32: all four wide;
    ``--tri-timing`` also float32 at the FoldModel's N = 4*256*256, C = 64,
    all four resident): each held against its plain version (its
    error folded into ``tri_worst``), timed by CUDA events
    (plain/kernel/kernel/plain), then under torch.profiler (device time a
    call, split by the kernels of the call: K5 and K7 are a rows pass or the
    wide chain, then the weight-gradient pass and two reductions).  Returns
    ({name: (kernel ms, plain ms, bound ms, bound_by)}, {name: the device
    split [(kernel, ms a call), ...]})."""
    from protstruc_tpu_torch.ops import tri_mul

    dtype = dtype or torch.bfloat16
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    phase = phase or ("phase 9" if dtype == torch.bfloat16 else "phase 9b")
    tri_ms, split = {}, {}
    cases = tri_inputs(torch, dev, dtype, C, B=4, L=L or L_FULL)
    for name in TRI_KERNELS:
        kernel, plain = tri_mul.KERNELS[name]
        route = tri_route(tri_mul, name, cases[name][0])
        if dtype == torch.bfloat16 and hasattr(tri_mul, "route"):
            check(route == "resident", f"{name} bf16 C=128 takes the {route} route, not resident")
        err = tri_kernel_vs_plain(torch, tri_mul, name, cases[name], f"{tag} C={C} ({phase})")
        tri_worst[name] = max(tri_worst[name], err)
        got = kernel(*cases[name])
        tri_b = tri_bound(torch, name, cases[name], got if isinstance(got, tuple) else (got,))
        N, C = cases[name][0].shape
        del got
        torch.cuda.empty_cache()
        plain_ms_k, kernel_ms_k, rounds = alternate(lambda: plain(*cases[name]), lambda: kernel(*cases[name]))
        tri_ms[name] = (kernel_ms_k, plain_ms_k, *tri_b)
        say(f"{phase} timing {name} {tag} N={N} C={C} ({route} route) [{smi}]: kernel {kernel_ms_k:.4f} ms, "
            f"plain {plain_ms_k:.4f} ms (plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)}); "
            f"bound {tri_b[0]:.4f} ms ({tri_b[1]}{', 3xTF32' if dtype == torch.float32 else ''})")
        _, busy, top = device_profile(torch, lambda: [kernel(*cases[name]) for _ in range(ITERS)], top=8)
        split[name] = [(kernel_name(k), ms / ITERS) for k, ms, _ in top]
        say(f"{phase} device time {name} {tag} [{smi}]: torch.profiler {busy / ITERS:.4f} ms a call = "
            + " + ".join(f"{k[:40]} {ms / ITERS:.4f}" for k, ms, _ in top))
    del cases
    torch.cuda.empty_cache()
    return tri_ms, split


def f32_train_step(torch, np, dev, smi, tri_mul):
    """Phase 9b: the TrFold train step at ``[mfu-fused]``'s widths (bench.py:
    338-345) in float32, the model's default dtype: B=4, L=512, N =
    4*512*512 pair rows of C = 128.  One fused step from the seeded init
    with every K4-K7 counter reset just before and read just after (all four
    must launch on the wide route alone, K4 and K6 four times a block, once
    for each triangle update and again in its remat recomputation, K5 and K7
    twice; a parent tree, timed against this one, whose counters have a
    "streamed" route runs its K4 and K6 there), then phase 9's timing in
    float32: fused against unfused in turns, the losses within 1e-5
    relative, one profiled step of each.  Returns (launches by kernel and
    route, {fused: (ms/step, peak GiB, device busy ms)})."""
    feats, models, init = train_models(torch, dev, dict(TRAIN_WIDTH, dtype=torch.float32), train_xyz(np))
    reset_launches(tri_mul)
    for counts in getattr(tri_mul, "ROUTE_LAUNCHES", {}).values():
        counts.update(dict.fromkeys(counts, 0))
    run_steps(feats, models[True], 1)
    torch.cuda.synchronize()
    routes = {k: {r: n for r, n in v.items() if n} for k, v in getattr(tri_mul, "ROUTE_LAUNCHES", {}).items()}
    check(all(n > 0 for n in tri_mul.LAUNCHES.values()), f"phase 9b f32 step: K4-K7 launches {tri_mul.LAUNCHES}")
    if f32_wide_tree(torch, dev, tri_mul):
        streamed_fwd = "streamed" in getattr(tri_mul, "ROUTES", ())  # a parent tree's K4 and K6
        for name in TRI_KERNELS:
            want = expected_tri_route(torch.float32, TRAIN_WIDTH["pair_dim"])
            want = "streamed" if streamed_fwd and name.endswith("_fwd") else want
            n = (4 if name.endswith("_fwd") else 2) * TRAIN_WIDTH["n_blocks"]
            check(routes[name] == {want: n}, f"phase 9b f32 step: {name} launches by route {routes[name]}, "
                                             f"not {n} on {want} only")
    say(f"phase 9b f32 [mfu-fused] step B=4 L={L_FULL} {TRAIN_WIDTH}: K4-K7 launches a step by route {routes}")
    timing = train_step_timing(torch, smi, models, feats, init, label="phase 9b", dtype="f32", loss_rtol=1e-5)
    del models, feats, init
    torch.cuda.empty_cache()
    return routes, timing


# -- bounds: the least time an H100 SXM could take for a call ------------------
HBM_BYTES_PER_S = 3.35e12                                # HBM3, NVIDIA's data sheet
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 outside the tensor cores; bf16 dense
# float32 operations per (b, i, j) pair, counted from the kernel sources (an
# atan2f counted as 15): K1's three distances, two dihedrals and one angle;
# K3's distance and bin, two dihedrals' sin/cos and phi's, each by one rsqrt
K1_OPS_PER_PAIR, K3_OPS_PER_PAIR = 204, 144
# (N, C) x (C, C) products of K4-K7 (2 N C^2 operations each): forward, or
# recompute + input gradient + weight gradient
TRI_PRODUCTS = {"prologue_fwd": 4, "prologue_bwd": 12, "epilogue_fwd": 2, "epilogue_bwd": 6}
# dense TF32 on the tensor cores (NVIDIA's data sheet): the least time of a
# float32 product at float32 accuracy is three TF32 products (3xTF32)
PEAK_OPS_PER_S["tf32"] = 494.7e12


def tri_bound(torch, name, args, outs):
    """(ms, by): K4-K7's bound for one call: each input and output once at
    the HBM rate, and the (N, C) x (C, C) products on the tensor cores, bf16
    at its peak, float32 as 3xTF32 (three TF32 products each) at the TF32
    peak."""
    N, C = args[0].shape
    ops = TRI_PRODUCTS[name] * 2 * N * C * C
    if args[0].dtype == torch.float32:
        return bound(nbytes(*args, *outs), 3 * ops, "tf32")
    return bound(nbytes(*args, *outs), ops, torch.bfloat16)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# the atom slots of xyz (B, L, A, 3) a kernel reads: K1 N, CA, O, CB; K3 N, CA, CB
K1_SLOTS, K3_SLOTS = 4, 3


def slot_bytes(xyz, n_slots):
    """Bytes of ``n_slots`` atom slots of every residue of ``xyz``."""
    return xyz.shape[0] * xyz.shape[1] * n_slots * 3 * xyz.element_size()


def bound(n_bytes, ops, dtype):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate of ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype).rsplit(".", 1)[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_ops(kmask, H, dh, products):
    """2 L Lk dh operations per (L, Lk, dh) product and (b, h), Lk the keys
    this run's mask allows in row b (masked keys need no work)."""
    L = kmask.shape[1]
    return products * 2 * H * L * dh * int(kmask.sum())


# -- the FoldModel slice ------------------------------------------------------
# experiments/fold_loo.py:36-48: the leave-one-out sweep's structures; its
# run_fold trains on all but the held-out one and the duplicate complex
LOO_FILES = ("1REX.pdb", "4EOT.pdb", "4uuj.pdb", "8dtk.pdb", "8gpi.pdb", "8ilx.pdb", "6dc4.pdb",
             "15c8_HL.pdb", "1a3r_HL.pdb", "1a6v_HL.pdb", "1a6v_JN.pdb", "1ad0_DC.pdb",
             "5cjx_HL.pdb")
HELD_OUT, DUPLICATE = "1REX.pdb", "1a6v_JN.pdb"
# its TrainConfig (fold_loo.py:57-63) with --flash-attn; 4 heads and 6 IPA
# iterations are TrainConfig's defaults, float32 (no --bf16) as there
FOLD_ARGV = ("--batch-size", "4", "--crop", "256", "--node-dim", "128", "--pair-dim", "64",
             "--blocks", "4", "--recycle", "1", "--pair-update", "triangle", "--remat",
             "--fused-tri", "--flash-attn", "--seed", "0")
FOLD_STEPS, FOLD_SAVE_EVERY = 8, 4
BATCH_FILES = ("4uuj.pdb", "8dtk.pdb", "6dc4.pdb", "1ad0_DC.pdb")  # 434-545 residues: all cropped
CROP_SEED = 7


def reset_launches(*modules):
    for m in modules:
        if isinstance(m.LAUNCHES, dict):
            for k in m.LAUNCHES:
                m.LAUNCHES[k] = 0
        else:
            m.LAUNCHES = 0


@contextlib.contextmanager
def plain_k3():
    """Inside, ``featurize_for_model(fused=True)`` takes K3's plain version
    on card tensors too: the plain path of phases 12 and 13."""
    from protstruc_tpu_torch.ops import model_features as mf

    kernel = mf.model_features
    mf.model_features = mf._model_features_plain
    try:
        yield
    finally:
        mf.model_features = kernel


def device_profile(torch, fn, top=6):
    """One call of ``fn`` under torch.profiler: (wall ms, device-busy ms, the
    ``top`` kernels by device time as (name, ms, calls))."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device events only; a record_function span (AdamW.step's) shows on the
    # device timeline too and is no kernel
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda k: -k[1])
    return wall, sum(k[1] for k in kernels), kernels[:top]


def kernel_name(key):
    """A profiler key without its parameter list and namespaces:
    ``epilogue_fwd_resident_kernel<float>``."""
    return re.sub(r"^void |\(anonymous namespace\)::", "", key).split("(")[0]


def fold_main_path(dev, tmp):
    """Phase 12's main path through the CLI: ``train`` (checkpoints, evals,
    metrics.jsonl), then ``fold`` of the held-out sequence.  Returns (the
    train command's metrics, its logged losses, its eval rows, its saved
    TrainConfig, the folded PDB's line)."""
    from protstruc_tpu_torch.__main__ import main as cli
    from protstruc_tpu_torch.models.checkpoint import all_steps
    from protstruc_tpu_torch.pdbio.parser import parse_pdb
    from protstruc_tpu_torch.train import TrainConfig
    import numpy as np

    ck, out_pdb = tmp / "ck", tmp / "fold_1REX.pdb"
    train_paths = [str(DATA / f) for f in LOO_FILES if f not in (HELD_OUT, DUPLICATE)]
    argv = ["train", *train_paths, "--checkpoint-dir", str(ck), "--steps", str(FOLD_STEPS),
            "--save-every", str(FOLD_SAVE_EVERY), *FOLD_ARGV, "--eval", str(DATA / HELD_OUT),
            "--device", str(dev)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli(argv) == 0, "train returned non-zero")
    metrics = json.loads(out.getvalue().strip().splitlines()[-1])
    rows = [json.loads(ln) for ln in (ck / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    evals = [r for r in rows if "eval_ca_lddt" in r]
    check(metrics["steps"] == FOLD_STEPS and len(losses) == FOLD_STEPS,
          f"train: {metrics}; {len(losses)} loss records")
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    saves = list(range(FOLD_SAVE_EVERY, FOLD_STEPS + 1, FOLD_SAVE_EVERY))
    check([r["step"] for r in evals] == saves
          and all(math.isfinite(r[k]) for r in evals for k in ("eval_ca_lddt", "eval_ca_rmsd")),
          f"eval rows {evals}")
    check(all_steps(str(ck)) == saves, f"checkpoints {all_steps(str(ck))}")
    cfg = TrainConfig.from_json((ck / "config.json").read_text())
    check(cfg.use_flash_attn and cfg.fused_tri and not cfg.bf16, f"saved config {cfg}")

    seq = ":".join(parse_pdb(str(DATA / HELD_OUT)).seq_dict().values())
    out = io.StringIO()
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a structure-conditioned checkpoint folds out of distribution
        check(cli(["fold", "--checkpoint-dir", str(ck), "--seq", seq, "--out", str(out_pdb),
                   "--device", str(dev)]) == 0, "fold returned non-zero")
    folded = parse_pdb(str(out_pdb))
    backbone = folded.atom_xyz[:, :4]
    check(folded.n_residues == len(seq.replace(":", "")) and bool(np.isfinite(backbone).all()),
          f"folded PDB: {folded.n_residues} residues for {len(seq)}, finite {np.isfinite(backbone).all()}")
    return metrics, losses, evals, cfg, out.getvalue().strip()


def fold_models(torch, dev, cfg):
    """One batch of real structures (BATCH_FILES) and a FoldModel per path
    from one init: the kernel path (``cfg``: flash and fused_tri on) and the
    plain path (both off).  Returns (batch, {kernel: (model, cfg)}, the
    initial state_dict)."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.train import _build_model

    sb = pt.StructureBatch.from_pdb([str(DATA / f) for f in BATCH_FILES], device=dev)
    models, init = {}, None
    for kernel in (True, False):
        c = dataclasses.replace(cfg, use_flash_attn=kernel, fused_tri=kernel)
        model = _build_model(c, dev)
        if init is None:
            model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        models[kernel] = (model, c)
    return sb, models, init


def fold_featurize(torch, batch, model, cfg, kernel):
    """The train loop's crop and featurization (seeded crop, K3 or its plain
    version); returns (feats, the cropped ground truth xyz)."""
    from protstruc_tpu_torch.train import _featurize

    with contextlib.nullcontext() if kernel else plain_k3():
        feats, _, crop = _featurize(batch, cfg, model.trunk_cfg,
                                    generator=torch.Generator().manual_seed(CROP_SEED))
    return feats, crop.xyz


#: profiles of one function taken before its device time is given up as not recorded
PROFILE_ATTEMPTS = 3


def device_ms(torch, fn):
    """Device time of one call of ``fn``: the self device time of every
    kernel under torch.profiler over ITERS calls (after WARMUP), per call;
    and the names of the three kernels that took most of it, largest first.
    A profile is whole when it holds a kernel and each kernel's calls are a
    multiple of ITERS (``fn`` launches the same kernels every call); one
    that is not (the profiler lost records) is taken again, up to
    PROFILE_ATTEMPTS in all, and if none is whole the result is (None, []):
    no record, never a time of 0 or of part of the calls."""
    for _ in range(WARMUP):
        fn()
    for _ in range(PROFILE_ATTEMPTS):
        _, busy, kernels = device_profile(torch, lambda: [fn() for _ in range(ITERS)], top=None)
        if kernels and all(calls % ITERS == 0 for _, _, calls in kernels):
            return busy / ITERS, [name for name, _, _ in kernels[:3]]
    return None, []


def fmt_ms(ms):
    """A device time from device_ms for a log line."""
    return "not recorded (no torch.profiler record)" if ms is None else f"{ms:.4f} ms"


def flash_timings(torch, dev, fa, label, dtype, B, H, dh, L):
    """K8 and K9 at one shape beside their plain versions and SDPA with the
    additive mask (forward without autograd; backward as one autograd.grad
    over a kept graph).  Returns ({fwd, bwd: (kernel ms, plain ms, SDPA ms,
    bound ms, bound_by)}, {name: (event ms, device ms, kernels)} for K8, K9,
    SDPA's forward and backward, and the whole flash backward: delta, K9 and
    dq = ds k, the work SDPA's backward does)."""
    import torch.nn.functional as F

    q, k, v, bias, kmask, do = flash_inputs(torch, dev, dtype, label, B, H, dh, L)
    out, lse = fa.flash_fwd(q, k, v, bias, kmask)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    fwd_args, bwd_args = (q, k, v, bias, kmask), (q, k, v, bias, kmask, do, lse, delta)
    fwd_plain, fwd_ms, _ = alternate(lambda: fa._flash_fwd_plain(*fwd_args), lambda: fa.flash_fwd(*fwd_args))
    bwd_plain, bwd_ms, _ = alternate(lambda: fa._flash_bwd_plain(*bwd_args), lambda: fa.flash_bwd(*bwd_args))
    ds, dk, dv = fa.flash_bwd(*bwd_args)

    def whole_bwd():
        d = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        ds_, _, _ = fa.flash_bwd(q, k, v, bias, kmask, do, lse, d)
        fa.dq_from_ds(ds_, k)

    # the forward on inputs that require no gradient, so SDPA may pick its
    # fastest kernel (cuDNN's takes no mask gradient); the backward on leaves
    # that do, the mask (the bias) included
    qf, kf, vf = (t.transpose(1, 2) for t in (q, k, v))
    mask_f = bias.masked_fill(~kmask[:, None, None, :], float("-inf"))
    qt, kt, vt = (t.detach().requires_grad_() for t in (qf, kf, vf))
    mask = mask_f.detach().requires_grad_()

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qf, kf, vf, attn_mask=mask_f)

    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    g = do.transpose(1, 2)

    def sdpa_bwd():
        torch.autograd.grad(o, (qt, kt, vt, mask), g, retain_graph=True)

    times = {}
    for name, fn in (("K8", lambda: fa.flash_fwd(*fwd_args)), ("SDPA forward", sdpa_fwd),
                     ("K9", lambda: fa.flash_bwd(*bwd_args)), ("SDPA backward", sdpa_bwd),
                     ("flash backward (delta + K9 + dq)", whole_bwd)):
        times[name] = (cuda_time_ms(fn), *device_ms(torch, fn))
    fwd_bound = bound(nbytes(q, k, v, bias, kmask, out, lse), flash_ops(kmask, H, dh, 2), dtype)
    bwd_bound = bound(nbytes(q, k, v, bias, kmask, do, lse, delta, ds, dk, dv),
                      flash_ops(kmask, H, dh, 4), dtype)
    return ({"fwd": (fwd_ms, fwd_plain, times["SDPA forward"][0], *fwd_bound),
             "bwd": (bwd_ms, bwd_plain, times["SDPA backward"][0], *bwd_bound)}, times)


FLASH_TIMING_SHAPES = (("train", "float32", 4, 4, 32, 256), ("attn", "bfloat16", 1, 8, 32, 4096))


def flash_phase13(torch, dev, fa, smi):
    """Phase 13's K8/K9 timings at the train and ``[attn]`` shapes, printed;
    returns {label: flash_timings' times}."""
    flash_ms = {}
    for label, dtype, B, H, dh, L in FLASH_TIMING_SHAPES:
        dtype = getattr(torch, dtype)
        flash_ms[label], times = flash_timings(torch, dev, fa, label, dtype, B, H, dh, L)
        torch.cuda.empty_cache()
        for part, (k_ms, p_ms, lib_ms, b_ms, b_by) in flash_ms[label].items():
            say(f"phase 13 timing K{8 if part == 'fwd' else 9} ({part}) {label} {str(dtype)[6:]} B={B} "
                f"H={H} dh={dh} L={L} [{smi}]: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA "
                f"{'forward' if part == 'fwd' else 'backward'} {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
        for name, (ev, dv, names) in times.items():
            say(f"phase 13 device time {name} {label} [{smi}]: CUDA events {ev:.4f} ms, torch.profiler "
                f"{fmt_ms(dv)} a call ({'; '.join(kernel_name(n)[:60] for n in names)})")
    return flash_ms

# -- K2 and the K1 probes ------------------------------------------------------
K2_TOL = 1e-5   # max|d| <= 1e-5 max(1, max|ref|): the JAX gate, tests/test_pallas_pairwise.py:94-141
# float32 operations per (b, i, j) pair, counted from csrc/pair_maps_bwd.cu as
# K1_OPS_PER_PAIR is (arithmetic only, no compares or selects): the three
# distance adjoints 24 each, the two dihedral adjoints 176 each, the angle's
# 86, and 18 adds to sum each side over the other index
K2_OPS_PER_PAIR = 528
K2_SLOTS = 4    # N, CA, O, CB read; dxyz written in full
# a probe's atan2 in operations: atan2f counted as 15, as in K1; the
# polynomial one by its terms (abs, max, min, ratio, Horner steps, the folds).
# A probe that computes the six maps does K1's operations with three of these
PROBE_ATAN2_OPS = {"full": 15, **{f"opt-d{d}{s}": 10 + 2 * ((d + 1) // 2 - 1) + (2 if s else 0)
                                  for d in (9, 11, 13, 15) for s in ("", "-fdiv")}}


def k2_check(torch, ref, got, label):
    """K2's dxyz against the plain version's: NaN patterns equal, the rest
    within K2_TOL * max(1, max|ref|); returns (max error, max|ref|)."""
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{label}: {tuple(got.shape)} {got.dtype} vs {tuple(ref.shape)} {ref.dtype}")
    nan_r, nan_g = torch.isnan(ref), torch.isnan(got)
    check(torch.equal(nan_r, nan_g), f"{label}: NaN patterns differ at {int((nan_r != nan_g).sum())} entries")
    r, g = ref.masked_fill(nan_r, 0), got.masked_fill(nan_g, 0)
    check(bool(torch.isfinite(g).all()), f"{label}: infinite gradient entries")
    err = float((r - g).abs().max()) if r.numel() else 0.0
    top = float(r.abs().max()) if r.numel() else 0.0
    check(err <= K2_TOL * max(1.0, top), f"{label}: max err {err:.3e} > {K2_TOL} * max(1, {top:.3e})")
    return err, top


def k2_case(torch, pm, x, grads, label, finite=False):
    """K2 (``maps_bwd`` on card tensors) against ``_maps_bwd_plain`` on the
    same tensors; returns the largest error."""
    got = pm.maps_bwd(x, grads)
    torch.cuda.synchronize()
    err, top = k2_check(torch, pm._maps_bwd_plain(x, grads), got, f"K2 {label}")
    if finite:
        check(bool(torch.isfinite(got).all()), f"K2 {label}: non-finite gradient")
    say(f"  K2 {label} B={x.shape[0]} L={x.shape[1]} maps {sorted(k for k, v in grads.items() if v is not None)}: "
        f"max err {err:.3e} (max|ref| {top:.3e}); NaN entries {int(torch.isnan(got).sum())}")
    return err


def cotangents(torch, x, seed, maps):
    """``(B, L, L)`` randn cotangents of ``maps`` for ``x``, drawn on its card."""
    gen = torch.Generator(x.device).manual_seed(seed)
    B, L = x.shape[:2]
    return {k: torch.randn((B, L, L), generator=gen, device=x.device) for k in maps}


def masked_map_loss(torch, g, weights):
    """Sum over the six maps of ``w_k * map_k`` under its mask (the distance
    maps' own, d_cb's for the angles) and finite; returns (loss, the
    cotangent each map receives)."""
    loss, cots = 0.0, {}
    for k, w in weights.items():
        mask = g.get(f"{k}_mask", g.get("d_cb_mask", g.get("pair_mask"))) & torch.isfinite(g[k])
        loss = loss + w * torch.where(mask, g[k], 0.0).sum()
        cots[k] = w * mask.float()
    return loss, cots


def k2_parity(torch, dev, pair_maps, small, xyz):
    """Phase 14: K2 against its plain version on card tensors (ragged L,
    the degenerate probes and batch, a NaN residue, a map subset with a
    ``None`` cotangent, B > 65535, and B=256, L=512 twice: the same bits);
    returns (largest error, the full-size cotangents)."""
    import numpy as np
    from protstruc_tpu_torch.ops.pair_maps import MAP_NAMES

    t0 = time.perf_counter()
    k2_worst = 0.0
    for seed, label in ((2, "B2 L37"), (2, "B2 L300"), (4, "probes")):
        k2_worst = max(k2_worst, k2_case(torch, pair_maps, small[label], cotangents(
            torch, small[label], seed, MAP_NAMES), label))
    deg_np = np.random.RandomState(0).randn(2, 192, 15, 3).astype(np.float32) * 5  # bench.py:445-453
    deg_np[:, ::3, 4] = deg_np[:, ::3, 1]     # CB == CA on every third residue
    deg_np[:, 7] = deg_np[:, 3]               # residue 7 = residue 3
    deg = torch.from_numpy(deg_np).to(dev)
    k2_worst = max(k2_worst, k2_case(torch, pair_maps, deg, cotangents(torch, deg, 3, MAP_NAMES),
                                     "degenerate", finite=True))
    nan_np = np.random.RandomState(3).randn(1, 16, 15, 3).astype(np.float32) * 5
    nan_np[:, 5, :4] = np.nan                 # residue 5's backbone missing
    nan_x = torch.from_numpy(nan_np).to(dev)
    k2_worst = max(k2_worst, k2_case(torch, pair_maps, nan_x, cotangents(torch, nan_x, 5, MAP_NAMES),
                                     "NaN residue"))
    sub_g = cotangents(torch, small["B2 L300"], 2, ("d_cb", "phi"))
    k2_worst = max(k2_worst, k2_case(torch, pair_maps, small["B2 L300"], dict(sub_g, d_ca=None),
                                     "subset, d_ca None"))
    many = torch.from_numpy(np.random.RandomState(6).randn(70000, 5, 15, 3).astype(np.float32) * 5).to(dev)
    k2_worst = max(k2_worst, k2_case(torch, pair_maps, many, cotangents(torch, many, 6, MAP_NAMES),
                                     "B > 65535", finite=True))
    del many
    g_full = cotangents(torch, xyz, 1, MAP_NAMES)
    got = pair_maps.maps_bwd(xyz, g_full)
    again = pair_maps.maps_bwd(xyz, g_full)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)), "K2 full: two runs differ in their bits")
    ref = torch.cat([pair_maps._maps_bwd_plain(xyz[b0:b0 + 32], {k: v[b0:b0 + 32] for k, v in g_full.items()})
                     for b0 in range(0, B_FULL, 32)])
    err, top = k2_check(torch, ref, got, "K2 full")
    check(bool(torch.isfinite(got).all()), "K2 full: non-finite gradient")
    k2_worst = max(k2_worst, err)
    del got, again, ref
    say(f"phase 14 parity K2 ok in {time.perf_counter() - t0:.2f} s: full B={B_FULL} L={L_FULL} max err "
        f"{err:.3e} (max|ref| {top:.3e}; the plain version in batch chunks of 32), the same bits on two "
        f"runs; largest over all cases {k2_worst:.3e}")
    return k2_worst, g_full


def sass_loop_mix(so_path, kernel):
    """The static instructions of ``kernel``'s largest innermost loop (a span
    from a backward branch's target to the branch that holds no other) in
    the SASS of library
    ``so_path`` (``cuobjdump -sass`` from the toolkit of nvcc): (count,
    [(opcode, count)] largest first), or None without cuobjdump."""
    import collections
    from protstruc_tpu_torch.ops import cuda_lib

    tool = pathlib.Path(cuda_lib.find_nvcc() or "nvcc").parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(so_path)], capture_output=True, text=True,
                          timeout=300).stdout
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        if cuda_lib.nested_name(body.split("\n", 1)[0].strip()) != kernel:
            continue
        ins = [(int(m.group(1), 16), m.group(2)) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body)]
        loops = [(int(t.group(1), 16), a) for a, txt in ins
                 for t in [re.search(r"BRA\s.*?0x([0-9a-f]+)", txt)] if t and int(t.group(1), 16) < a]
        inner = [ab for ab in loops if not any(o != ab and ab[0] <= o[0] and o[1] <= ab[1] for o in loops)]
        if not inner:
            return None
        lo, hi = max(inner, key=lambda ab: ab[1] - ab[0])
        ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", txt).split()[0].split(".")[0]
                                  for a, txt in ins if lo <= a <= hi)
        return sum(ops.values()), ops.most_common()
    return None


def grad_timing(torch, dev, smi):
    """``--grad-timing``: K2 alone at B=256, L=512 with six random
    cotangents (phase 16's inputs), CUDA-event and torch.profiler device
    times, beside its bound, with the K2 library's ptxas lines, in whatever
    checkout holds this script."""
    import numpy as np
    from protstruc_tpu_torch.ops import cuda_lib, pair_maps as pm

    t0 = time.perf_counter()
    pm.load_bwd_library()
    say(f"grad timing of {REPO}: K2 built or loaded in {time.perf_counter() - t0:.2f} s")
    for ln in cuda_lib.ptxas_lines(pm.bwd_library_path().with_suffix(".log")):
        say(f"  ptxas K2: {ln}")
    xyz = torch.from_numpy(np.random.RandomState(0).randn(B_FULL, L_FULL, 15, 3).astype(np.float32) * 10).to(dev)
    g_full = cotangents(torch, xyz, 1, pm.MAP_NAMES)
    got = pm.maps_bwd(xyz, g_full)
    b_ms, b_by = bound(slot_bytes(xyz, K2_SLOTS) + nbytes(*g_full.values(), got),
                       K2_OPS_PER_PAIR * B_FULL * L_FULL ** 2, torch.float32)
    ev = cuda_time_ms(lambda: pm.maps_bwd(xyz, g_full))
    dv, names = device_ms(torch, lambda: pm.maps_bwd(xyz, g_full))
    say(f"grad timing K2 B={B_FULL} L={L_FULL} six maps [{smi}]: event {ev:.4f} ms, device {fmt_ms(dv)} "
        f"({'; '.join(kernel_name(n) for n in names)}); bound {b_ms:.4f} ms ({b_by})")
    mix = sass_loop_mix(pm.bwd_library_path(), "pair_maps_bwd_kernel")
    if mix:
        n, ops = mix
        fp = sum(c for op, c in ops if op in ("FADD", "FMUL", "FFMA", "MUFU"))
        say(f"grad timing K2 SASS: the kernel's largest inner loop (its pairs) holds {n} instructions, {fp} of them "
            f"FADD/FMUL/FFMA/MUFU: {', '.join(f'{op} {c}' for op, c in ops[:16])}")


# -- the served and analysis path (phase 18) -------------------------------------
SERVE_ANALYZE = ("1REX.pdb", "4uuj.pdb", "8dtk.pdb", "6dc4.pdb", "1ad0_DC.pdb")
SERVE_FOLDS = ("1REX.pdb", "1ad0_DC.pdb", "1REX.pdb")  # held out (130), a complex (434), again
SERVE_TIMED = 20     # timed requests of each kind, after one warm-up
EVENT_REPS = 3       # CUDA-event repetitions of the batch analysis ops, after one warm-up
FOLD_FWD = ("prologue_fwd", "epilogue_fwd", "fwd")   # K4, K6, K8: launched by a served fold
FOLD_BWD = ("prologue_bwd", "epilogue_bwd", "bwd")   # K5, K7, K9: never
# one unit of the last digit each analyze field prints (its round())
ANALYZE_UNITS = {"radius_of_gyration_A": 1e-2, "relative_contact_order": 1e-4,
                 "clash_energy": 1e-3, "helix_frac": 1e-3, "strand_frac": 1e-3,
                 "rama_favored_frac": 1e-3, "rama_outlier_frac": 1e-3, "total_sasa_A2": 1e-1}
SS_NEAR = 1e-4       # an H-bond energy this close to -0.5 kcal/mol may flip between devices


def bundled_pdbs():
    """The bundled structures, in name order."""
    return sorted(str(p) for p in DATA.glob("*.pdb"))


def fold_seq(name):
    """A bundled structure's chains' sequences joined by ':' (the fold op's
    multi-chain form), its non-standard residues (the parser's X, one in
    1ad0_DC) as alanine: the PDB writer, the JAX package's too, has no
    three-letter name for X."""
    from protstruc_tpu_torch.pdbio.parser import parse_pdb

    return ":".join(parse_pdb(str(DATA / name)).seq_dict().values()).replace("X", "A")


class ServeClock:
    """JSONL in and out of ``serve_loop`` with the host clock at each
    request's read and each response's write; ``before(i, req)`` runs just
    before request ``i`` is handed over."""

    def __init__(self, reqs, before=None):
        self.reqs, self.before = reqs, before
        self.t_in, self.t_out, self.lines = [], [], []

    def __iter__(self):
        for i, req in enumerate(self.reqs):
            if self.before is not None:
                self.before(i, req)
            self.t_in.append(time.perf_counter())
            yield json.dumps(req)

    def write(self, text):
        if text.strip():
            self.t_out.append(time.perf_counter())
            self.lines.append(json.loads(text))

    def flush(self):
        pass

    def ms(self):
        """Wall ms of each request, read to response (the ready line first)."""
        return [(b - a) * 1e3 for a, b in zip(self.t_in, self.t_out[1:])]


def serve_clocked(serve_loop, reqs, before=None, **kw):
    clock = ServeClock(reqs, before)
    check(serve_loop(clock, clock, **kw) == 0, f"serve_loop({kw.get('device')}) returned non-zero")
    check(len(clock.lines) == len(reqs) + 1, f"{len(clock.lines)} replies to {len(reqs)} requests")
    return clock


def served_requests(work, tag):
    fold_out = [str(work / f"{tag}_fold{i}_{p}") for i, p in enumerate(SERVE_FOLDS)]
    return ([{"op": "ping"},
             {"op": "featurize", "path": str(DATA / "1REX.pdb"), "out": str(work / f"{tag}_1REX.npz")}]
            + [{"op": "analyze", "path": str(DATA / p)} for p in SERVE_ANALYZE]
            + [{"op": "fold", "seq": fold_seq(p), "out": o} for p, o in zip(SERVE_FOLDS, fold_out)]
            + [{"op": "nope"}, {"op": "shutdown"}])


def pdb_atoms(path):
    """(record heads, xyz (n, 3), B-factors (n,)) of a PDB's ATOM lines."""
    import numpy as np

    rows = [ln for ln in open(path) if ln.startswith("ATOM")]
    return ([ln[:30] for ln in rows],
            np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in rows]),
            np.array([float(ln[60:66]) for ln in rows]))


def hbond_flips(torch, path, dev, ref_dev="cpu"):
    """H-bond map entries that differ between two devices for one PDB, and
    how many of those lie farther than SS_NEAR from the -0.5 cutoff."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.ops.secondary import hbond_energy_map

    maps = []
    for d in (ref_dev, dev):
        sb = pt.StructureBatch.from_pdb(path, device=d)
        maps.append(hbond_energy_map(*sb._backbone_nan0(), sb.residue_mask, sb.chain_idx).cpu())
    ref, got = maps
    diff = (ref < -0.5) != (got < -0.5)
    return int(diff.sum()), int((diff & ((ref + 0.5).abs() >= SS_NEAR)).sum())


def run_cli(cli, argv):
    """``cli(argv)`` with its standard output and error captured."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a structure-conditioned checkpoint folds out of distribution
        rc = cli(argv)
    check(rc == 0, f"{argv[0]} returned {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def finite_numbers(obj):
    if isinstance(obj, dict):
        return all(finite_numbers(v) for v in obj.values())
    if isinstance(obj, list):
        return all(finite_numbers(v) for v in obj)
    return not isinstance(obj, float) or math.isfinite(obj)


def compare_reports(torch, ref, got, paths, label, dev):
    """Two ``analyze`` reports of the same files: every number within one
    unit of its printed digit, strings equal (an SS8 difference must trace
    to H-bond energies within SS_NEAR of the cutoff).  Returns the largest
    difference of each numeric field."""
    check(sorted(ref) == sorted(got), f"{label}: report keys {sorted(got)} vs {sorted(ref)}")
    worst = {}
    for key, unit in ANALYZE_UNITS.items():
        if key in ref:
            d = max(abs(a - b) for a, b in zip(ref[key], got[key]))
            check(d <= unit * (1 + 1e-6), f"{label}: {key} {got[key]} vs {ref[key]}")
            worst[key] = d
    check(ref["n_residues"] == got["n_residues"] and ref["n_structures"] == got["n_structures"],
          f"{label}: sizes {got['n_residues']} vs {ref['n_residues']}")
    for i, (a, b) in enumerate(zip(ref.get("dssp8", []), got.get("dssp8", []))):
        if a != b:
            flips, far = hbond_flips(torch, paths[i], dev)
            check(far == 0, f"{label}: dssp8 of {paths[i]} differs with {far} H-bond flips far "
                            f"from the cutoff")
            say(f"  phase 18 {label}: dssp8 of {paths[i]} differs through {flips} H-bond energies "
                f"within {SS_NEAR} of the cutoff")
    return worst


def percentiles(ms):
    s = sorted(ms)
    return s[len(s) // 2], s[min(len(s) - 1, int(0.9 * len(s)))]


def event_ms(torch, fn, reps=EVENT_REPS):
    """CUDA-event ms of one call of ``fn`` over ``reps`` calls, after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def served_path(torch, dev, smi, ck, work):
    """Phase 18: the server's analyze and fold ops, the analyze, score and
    convert commands and fold --relax on the card, each held to the CPU;
    then their request latencies.  ``ck`` is phase 12's checkpoint."""
    import numpy as np

    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.__main__ import main as cli, serve_loop
    from protstruc_tpu_torch.ops import flash_attn, tri_mul
    from protstruc_tpu_torch.pdbio.parser import parse_pdb
    from protstruc_tpu_torch.pdbio.writer import structure_batch_to_pdb
    from protstruc_tpu_torch.train import fold_with_model, load_fold_model

    def fold_launches():
        return {**{k: tri_mul.LAUNCHES[k] for k in FOLD_FWD[:2] + FOLD_BWD[:2]},
                **{f"flash_{k}": flash_attn.LAUNCHES[k] for k in ("fwd", "bwd")}}

    # 1. the server on the card, then the same requests on the CPU
    def reset_at_first_fold(i, req):
        if req["op"] == "fold" and not any(r["op"] == "fold" for r in reqs[:i]):
            reset_launches(tri_mul, flash_attn)

    t0 = time.perf_counter()
    reqs = served_requests(work, "card")
    card = serve_clocked(serve_loop, reqs, reset_at_first_fold, checkpoint_dir=str(ck),
                         buckets=(256, 512), device=str(dev))
    launches = fold_launches()
    card_s = time.perf_counter() - t0
    for k in ("prologue_fwd", "epilogue_fwd", "flash_fwd"):
        check(launches[k] > 0, f"the served fold launched {k} no time: {launches}")
    for k in ("prologue_bwd", "epilogue_bwd", "flash_bwd"):
        check(launches[k] == 0, f"the served fold launched {k} {launches[k]} times: {launches}")
    cpu = serve_clocked(serve_loop, served_requests(work, "cpu"), checkpoint_dir=str(ck),
                        buckets=(256, 512), device="cpu")
    for i, (r, g) in enumerate(zip(cpu.lines, card.lines)):
        req = reqs[i - 1] if i else {"op": "ready"}
        if req["op"] in ("fold", "featurize"):
            check(g.get("ok") and sorted(g) == sorted(r), f"{req['op']} reply {g} vs CPU {r}")
        elif req["op"] == "analyze":
            same = {k: g.get(k) == r.get(k) for k in ("ok", "n_residues", "helix_frac", "strand_frac")}
            if not all(same.values()):
                flips, far = hbond_flips(torch, req["path"], dev)
                check(g.get("ok") and same["n_residues"] and far == 0,
                      f"analyze {req['path']}: {g} vs CPU {r} ({far} H-bond flips far from the cutoff)")
                say(f"  phase 18 analyze {req['path']}: SS fractions differ through {flips} H-bond "
                    f"energies within {SS_NEAR} of the cutoff")
        else:  # ready, ping, the unknown op's error, shutdown
            check(g == r, f"{req['op']} reply {g} vs CPU {r}")
    rg_err = 0.0
    for p in SERVE_ANALYZE:
        ref = float(pt.StructureBatch.from_pdb(str(DATA / p), device="cpu").radius_of_gyration()[0])
        got = float(pt.StructureBatch.from_pdb(str(DATA / p), device=dev).radius_of_gyration()[0])
        check(abs(got - ref) <= 1e-5 * max(1.0, abs(ref)), f"Rg of {p}: card {got!r} vs CPU {ref!r}")
        rg_err = max(rg_err, abs(got - ref))
    pdb_err = [0.0, 0.0]
    for r, g in zip(cpu.lines, card.lines):
        if "mean_plddt" in g:
            (hr, xr, br), (hg, xg, bg) = pdb_atoms(r["out"]), pdb_atoms(g["out"])
            check(hr == hg, f"folded {g['out']}: atom records differ from the CPU's")
            # the PDB prints 3 and 2 decimals: one more unit of each beside the bound
            pdb_err = [max(pdb_err[0], float(np.abs(xg - xr).max())), max(pdb_err[1], float(np.abs(bg - br).max()))]
    check(pdb_err[0] <= 2e-3 and pdb_err[1] <= 2e-2, f"served PDBs card vs CPU: max |dxyz| "
          f"{pdb_err[0]}, max |dpLDDT| {pdb_err[1]}")
    models = {d: load_fold_model(str(ck), device=d) for d in ("cpu", dev)}
    fold_err = [0.0, 0.0]
    for p in SERVE_FOLDS[:2]:
        ref, got = ([t.float().cpu() for t in fold_with_model(*models[d], fold_seq(p), return_confidence=True)[:2]]
                    for d in ("cpu", dev))
        fold_err = [max(fold_err[0], float((got[0] - ref[0]).abs().max())),
                    max(fold_err[1], float((got[1] - ref[1]).abs().max()))]
    check(fold_err[0] <= 1e-3 and fold_err[1] <= 1e-2, f"fold card vs CPU: max |dxyz| {fold_err[0]} A, "
          f"max |dpLDDT| {fold_err[1]}")
    say(f"phase 18 server: ok in {card_s:.2f} s on the card; {len(reqs)} requests (ping, featurize, "
        f"analyze {SERVE_ANALYZE}, fold {SERVE_FOLDS}, an unknown op, shutdown); served fold launches "
        f"{launches} (K4 prologue_fwd, K6 epilogue_fwd, K8 flash_fwd; K5, K7, K9 none); card vs CPU: "
        f"analyze replies equal, Rg max |d| {rg_err:.3e}; fold max |dxyz| {fold_err[0]:.3e} A, max "
        f"|dpLDDT| {fold_err[1]:.3e}; served PDBs max |dxyz| {pdb_err[0]:.3e}, max |dB| {pdb_err[1]:.3e}")

    # 2. analyze: the bundled structures as one batch on the card; two against the CPU
    paths = bundled_pdbs()
    t0 = time.perf_counter()
    report = json.loads(run_cli(cli, ["analyze", *paths, "--ss8", "--sasa", "--device", str(dev)])[0])
    analyze_s = time.perf_counter() - t0
    check(report["n_structures"] == len(paths) and finite_numbers(report),
          f"analyze of {len(paths)} structures: {report['n_structures']} reported, finite "
          f"{finite_numbers(report)}")
    worst = {}
    for files, flags in (([str(DATA / "1REX.pdb")], ["--ss8", "--sasa"]),
                         ([str(DATA / "15c8_HL.pdb")], ["--ss8"])):
        reps = [json.loads(run_cli(cli, ["analyze", *files, *flags, "--device", d])[0])
                for d in ("cpu", str(dev))]
        for k, v in compare_reports(torch, *reps, files, f"analyze {files[0]}", dev).items():
            worst[k] = max(worst.get(k, 0.0), v)
    say(f"phase 18 analyze: ok; {len(paths)} structures as one batch (--ss8 --sasa) in "
        f"{analyze_s:.2f} s on the card [{smi}], every value finite; 1REX (--ss8 --sasa) and 15c8_HL "
        f"(--ss8) card vs CPU: SS8 strings equal, largest differences {worst}")

    # 3. score
    folded = card.lines[1 + reqs.index(next(r for r in reqs if r["op"] == "fold"))]["out"]
    rex = str(DATA / "1REX.pdb")
    vs_native = json.loads(run_cli(cli, ["score", folded, rex, "--device", str(dev)])[0])
    self_rex = json.loads(run_cli(cli, ["score", rex, rex, "--device", str(dev)])[0])
    check(self_rex["tm_score"] > 0.999 and self_rex["ca_rmsd"] < 1e-3, f"1REX against itself: {self_rex}")
    cpx = str(DATA / "1ad0_DC.pdb")
    self_cpx = json.loads(run_cli(cli, ["score", cpx, cpx, "--device", str(dev)])[0])
    check(self_cpx["dockq"] > 0.999 and self_cpx["capri_band"] == "high", f"1ad0_DC against itself: {self_cpx}")
    sb = pt.StructureBatch.from_pdb(cpx, device=dev)
    moved_path = str(work / "1ad0_DC_moved.pdb")
    structure_batch_to_pdb(sb.replace(xyz=torch.where((sb.chain_idx == 1)[:, :, None, None],
                                                      sb.xyz + 8.0, sb.xyz)), moved_path)
    moved = json.loads(run_cli(cli, ["score", moved_path, cpx, "--device", str(dev)])[0])
    check(moved["dockq"] < self_cpx["dockq"] - 0.2, f"1ad0_DC, chain 1 moved 8 A: {moved}")
    say(f"phase 18 score: ok; folded 1REX (phase 12's 8-step checkpoint) vs native {vs_native}; "
        f"1REX vs itself {self_rex}; 1ad0_DC vs itself {self_cpx}; chain 1 moved 8 A {moved}")

    # 4. convert
    cif, back = str(work / "15c8_HL.cif"), str(work / "15c8_HL_back.pdb")
    run_cli(cli, ["convert", str(DATA / "15c8_HL.pdb"), cif, "--device", str(dev)])
    run_cli(cli, ["convert", cif, back, "--device", str(dev)])
    a, b = parse_pdb(str(DATA / "15c8_HL.pdb")), parse_pdb(back)
    m = a.atom_mask & b.atom_mask
    conv_err = float(np.abs(a.atom_xyz[m] - b.atom_xyz[m]).max())
    check(a.n_residues == b.n_residues and m.sum() == a.atom_mask.sum() and conv_err <= 5e-4 + 1e-6,
          f"15c8_HL pdb -> cif -> pdb: {b.n_residues} residues for {a.n_residues}, "
          f"{int(m.sum())} of {int(a.atom_mask.sum())} atoms, max |d| {conv_err}")
    say(f"phase 18 convert: ok; 15c8_HL.pdb -> .cif -> .pdb, {int(m.sum())} atoms, max |d| "
        f"{conv_err:.3e} A")

    # 5. fold --relax on the card
    relaxed = str(work / "relaxed_1REX.pdb")
    t0 = time.perf_counter()
    _, err = run_cli(cli, ["fold", "--checkpoint-dir", str(ck), "--seq", fold_seq("1REX.pdb"),
                           "--out", relaxed, "--relax", "20", "--device", str(dev)])
    relax_s = time.perf_counter() - t0
    line = next(ln for ln in err.splitlines() if ln.startswith("relaxed 20 steps"))
    e0, e1 = (float(x) for x in line.split("energy")[1].split("->"))
    _, xyz, _ = pdb_atoms(relaxed)
    check(e1 < e0 and bool(np.isfinite(xyz).all()), f"fold --relax 20: {line}; finite {np.isfinite(xyz).all()}")
    say(f"phase 18 fold --relax 20: ok in {relax_s:.2f} s (model load, fold, 20 Adam steps, write) "
        f"[{smi}]; {line}; {len(xyz)} atoms, all finite")

    # 6. timing
    analyze_reqs = {p: {"op": "analyze", "path": str(DATA / p)} for p in ("1REX.pdb", "4uuj.pdb")}
    fold_reqs = {p: {"op": "fold", "seq": fold_seq(p), "out": str(work / f"timed_{p}")}
                 for p in ("1REX.pdb", "1ad0_DC.pdb")}
    timed = [r for r in (*analyze_reqs.values(), *fold_reqs.values()) for _ in range(SERVE_TIMED + 1)]
    clock = serve_clocked(serve_loop, timed + [{"op": "shutdown"}], checkpoint_dir=str(ck),
                          buckets=(256, 512), device=str(dev))
    check(all(ln["ok"] for ln in clock.lines), "a timed request failed")
    ms = clock.ms()
    latency = {}
    for k, name in enumerate([f"analyze {p}" for p in analyze_reqs] + [f"fold {p}" for p in fold_reqs]):
        block = ms[k * (SERVE_TIMED + 1):(k + 1) * (SERVE_TIMED + 1)]
        latency[name] = (block[0], *percentiles(block[1:]))
    first_fold = latency["fold 1REX.pdb"][0]
    for name, (first, p50, p90) in latency.items():
        say(f"phase 18 timing served {name} [{smi}]: p50 {p50:.3f} ms, p90 {p90:.3f} ms wall per request "
            f"over {SERVE_TIMED} after one warm-up ({first:.3f} ms)")
    say(f"phase 18 timing served first fold [{smi}]: {first_fold:.3f} ms (loads the checkpoint onto the "
        f"card, then folds 1REX)")
    model = load_fold_model(str(ck), device=dev)
    for p in ("1REX.pdb", "1ad0_DC.pdb"):
        seq = fold_seq(p)
        fold_with_model(*model, seq, return_confidence=True)
        wall, busy, every = device_profile(torch, lambda: fold_with_model(*model, seq, return_confidence=True),
                                           top=None)
        named = [(kernel_name(n), t, c) for n, t, c in every
                 if re.search(r"(prologue_fwd|epilogue_fwd|flash_fwd)\w*_kernel<", n)]
        say(f"phase 18 profile fold {p} ({len(seq.replace(':', ''))} residues) under torch.profiler "
            f"[{smi}]: device busy {busy:.3f} of {wall:.3f} ms wall (idle {100 * (1 - busy / wall):.1f}%); "
            + "; ".join(f"{n} {t:.3f} ms x{c}" for n, t, c in named)
            + "; top " + "; ".join(f"{n[:50]} {t:.3f} ms x{c}" for n, t, c in every[:4]))
    sb = pt.StructureBatch.from_pdb(paths, device=dev)
    ops = {"sasa": sb.sasa, "clash_energy": sb.clash_energy, "secondary_structure": sb.secondary_structure}
    op_ms = {name: event_ms(torch, fn) for name, fn in ops.items()}
    say(f"phase 18 timing analysis ops on the {len(paths)}-structure batch B={sb.batch_size} "
        f"L={sb.n_residues} [{smi}]: " + "; ".join(f"{k} {v:.3f} ms" for k, v in op_ms.items())
        + f" (CUDA events, {EVENT_REPS} calls after one)")
    return latency


# -- the batch API at BASELINE sizes (phase 19) -----------------------------------
# BASELINE.md:39-45, at the sizes bench.py:700-821 gives them
CFG2_FILES = ("15c8_HL.pdb", "1a3r_HL.pdb", "1a6v_HL.pdb", "1a6v_JN.pdb", "1ad0_DC.pdb",
              "5cjx_HL.pdb", "6dc4.pdb", "1REX.pdb")
CFG2_CPU_ROWS = (0, 6)       # structures of config 2's (L, L, A, A) tensor held against the CPU
CFG3_FILES, CFG3_B = 8, 64  # 6dc4 x8 in one batch, tiled to 64
CFG4_B, CFG4_T, CFG4_CPU_ROWS = 256, 300, 8
CFG5_B = CFG5_L = 1024
# K1 d_cb held bitwise to its plain version on 16 structures from both ends of the batch, so
# that the smallest and the largest output offsets ((b L + i) L + j up to 2^30) are both read
CFG5_PLAIN_ROWS = (*range(8), *range(CFG5_B - 8, CFG5_B))
CFG5_PLAIN_CALLS = 16        # the plain version timed as 16 calls of 64 structures
NERF_RESIDUES = (1, 10, 100, 300, 1000, 1023)   # residues (0-based) whose NeRF error is printed
RECONSTRUCT = (("1REX.pdb", 1.5), ("15c8_HL.pdb", 2.5))   # tests/test_reconstruct.py:150-153
MDS_ITERS = 200
COORD_ATOL = COORD_RTOL = 1e-5   # card vs CPU: coordinates, distances (one ulp past 64 A is 7.6e-6)
MDS_FIT_ATOL = 1e-3              # card vs CPU MDS coordinates after a proper Kabsch fit


def config5_torsions(np):
    """BASELINE config 5's backbone torsions: B=1024 x L=1024 x 3, numpy seed 1."""
    return np.random.RandomState(1).uniform(-3.1, 3.1, (CFG5_B, CFG5_L, 3)).astype(np.float32)


def config5_xyz(torch, pt, tor, dev):
    """Config 5's coordinates on ``dev``: torsions -> NeRF -> the actual CB in
    slot 4; returns (the NeRF batch, CB, the A=15 coordinates)."""
    sb5 = pt.StructureBatch.from_dihedrals(tor, device=dev)
    n, ca, c = (sb5.xyz[:, :, k] for k in range(3))
    b_v, c_v = ca - n, c - ca
    cb = -0.58273431 * torch.linalg.cross(b_v, c_v) + 0.56802827 * b_v - 0.54067466 * c_v + ca
    xyz15 = sb5.xyz.clone()
    xyz15[:, :, 4] = cb
    return sb5, cb, xyz15


def batch_api_phase(torch, np, dev, smi):
    """Phase 19: BASELINE configs 1-5 on the card, each held against the
    port's CPU path, then the reconstruction path and ``renumber``.
    Returns the kernels line's record of K1's d_cb-only launch."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.ops import pair_maps
    from protstruc_tpu_torch.utils.buckets import concat_batches, pad_batch_to_bucket

    check(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
          "phase 19 needs float32 matmuls without TF32 (the JAX package's precision='highest')")
    say(f"phase 19 precision: torch.backends.cuda.matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()!r}")
    cpu = torch.device("cpu")

    # -- config 1: one antibody, CA-CA distances and backbone dihedrals
    path = str(DATA / "15c8_HL.pdb")
    sb, sb_cpu = pt.StructureBatch.from_pdb(path, device=dev), pt.StructureBatch.from_pdb(path, device="cpu")

    def cfg1(b):
        return (*b.pairwise_atom_distance("CA", "CA"), *b.backbone_dihedrals())

    errs = [compare(r, g, f"config 1 {n}", COORD_ATOL, COORD_RTOL)[0]
            for n, r, g in zip(("d_ca", "mask", "dihedrals", "dihedral mask"), cfg1(sb_cpu), cfg1(sb))]
    ms = cuda_time_ms(lambda: cfg1(sb))
    say(f"phase 19 config 1 [{smi}]: 15c8_HL (L={sb.n_residues}) CA-CA distances + backbone dihedrals "
        f"{ms:.4f} ms (CUDA events); card vs CPU max err {max(errs):.3e}, masks equal")

    # -- config 2: 8 PDBs padded to their bucket
    paths = [str(DATA / f) for f in CFG2_FILES]
    sb8 = pad_batch_to_bucket(pt.StructureBatch.from_pdb(paths, device=dev))
    sb8_cpu = sb8.to("cpu")
    d, m = sb8.pairwise_distance_matrix()
    rows = list(CFG2_CPU_ROWS)
    d_ref, m_ref = pt.StructureBatch(xyz=sb8_cpu.xyz[rows], atom_mask=sb8_cpu.atom_mask[rows],
                                     chain_idx=sb8_cpu.chain_idx[rows],
                                     residue_idx=sb8_cpu.residue_idx[rows]).pairwise_distance_matrix()
    err_d = compare(d_ref, d[rows], "config 2 distance matrix", COORD_ATOL, COORD_RTOL)[0]
    compare(m_ref, m[rows], "config 2 distance mask")
    shape, gb = tuple(d.shape), (d.numel() * 4 + m.numel()) / 1e9
    del d, m, d_ref, m_ref
    ms_d = cuda_time_ms(lambda: sb8.pairwise_distance_matrix())
    torch.cuda.empty_cache()
    rot, trans = sb8.backbone_orientations(), sb8.backbone_translations()
    err_f = max(compare(sb8_cpu.backbone_orientations(), rot, "config 2 orientations", COORD_ATOL, COORD_RTOL)[0],
                compare(sb8_cpu.backbone_translations(), trans, "config 2 translations", COORD_ATOL,
                        COORD_RTOL)[0])
    ms_f = cuda_time_ms(lambda: (sb8.backbone_orientations(), sb8.backbone_translations()))
    ok = sb8.get_residue_mask() & torch.isfinite(rot).all(-1).all(-1)
    kw = dict(chain_idx=sb8.chain_idx, chain_ids=sb8.chain_ids, residue_idx=sb8.residue_idx,
              include_cb=True)
    back = pt.StructureBatch.from_backbone_orientations_translations(
        torch.nan_to_num(rot), torch.nan_to_num(trans), device=dev, **kw)
    back_cpu = pt.StructureBatch.from_backbone_orientations_translations(
        torch.nan_to_num(rot).cpu(), torch.nan_to_num(trans).cpu(), device="cpu", **kw)
    err_b = compare(back_cpu.xyz, back.xyz, "config 2 round trip xyz", COORD_ATOL, COORD_RTOL)[0]
    compare(back_cpu.atom_mask, back.atom_mask, "config 2 round trip mask")
    rt = float((back.backbone_orientations() - rot).abs()[ok].max())
    check(rt < 1e-5, f"config 2: frames after the round trip off by {rt:.3e}")
    ms_b = cuda_time_ms(lambda: pt.StructureBatch.from_backbone_orientations_translations(
        torch.nan_to_num(rot), torch.nan_to_num(trans), device=dev, **kw))
    say(f"phase 19 config 2 [{smi}]: {len(CFG2_FILES)} PDBs B={sb8.batch_size} L={sb8.n_residues}: pairwise_distance_matrix "
        f"{shape} ({gb:.2f} GB with its mask) {ms_d:.4f} ms, structures {rows} vs CPU max err {err_d:.3e}; "
        f"orientations + translations {ms_f:.4f} ms (max err {err_f:.3e}); "
        f"from_backbone_orientations_translations {ms_b:.4f} ms (vs CPU {err_b:.3e}, frames back within {rt:.3e})")
    del back, back_cpu, rot, trans
    torch.cuda.empty_cache()

    # -- config 3: antibody batch B=64, pair angles and chain/CDR masks
    ab_path = str(DATA / "6dc4.pdb")
    ab8 = pad_batch_to_bucket(pt.AntibodyStructureBatch.from_pdb([ab_path] * CFG3_FILES, "H", "L",
                                                                 device=dev))
    ab = concat_batches([ab8] * (CFG3_B // CFG3_FILES))
    ab_cpu = pt.AntibodyStructureBatch.from_pdb(ab_path, "H", "L", device="cpu")
    ab_cpu = pad_batch_to_bucket(ab_cpu)

    def cfg3(b):
        h = b.get_heavy_chain_mask()
        return (b.pairwise_dihedrals(("CA", "CB"), ("CA", "CB")),
                b.pairwise_dihedrals(("N", "CA", "CB"), ("CB",)),
                b.pairwise_planar_angles(("CA", "CB"), ("CB",)),
                h[:, :, None] & h[:, None, :], b.get_cdr_mask())

    out, ref = cfg3(ab), cfg3(ab_cpu)
    names = ("omega", "theta", "phi", "heavy pair mask", "CDR mask")
    errs = [compare(r[0], g[0], f"config 3 {n}", COORD_ATOL, COORD_RTOL)[0]
            for n, r, g in zip(names, ref, out)]
    for n, g in zip(names, out):
        same = (g == g[:1]) | (torch.isnan(g) & torch.isnan(g[:1])) if g.is_floating_point() else g == g[:1]
        check(bool(same.all()), f"config 3 {n}: the {CFG3_B} copies differ")
    for k, v in ab_cpu.residue_masks.items():
        compare(v.expand(CFG3_B, -1), ab.residue_masks[k], f"config 3 mask {k}")
    ms = cuda_time_ms(lambda: cfg3(ab))
    say(f"phase 19 config 3 [{smi}]: AntibodyStructureBatch 6dc4 (H/L) x{CFG3_FILES} padded to {ab.n_residues}, "
        f"tiled to B={ab.batch_size}: omega, theta, phi + heavy pair mask + CDR mask {ms:.4f} ms "
        f"({ab.batch_size / ms * 1e3:.0f} structures/s); vs CPU max err {max(errs):.3e}; the nine "
        f"named masks equal to the CPU port's ({int(ab.get_cdr_mask()[0].sum())} CDR residues)")
    del out, ab, ab8
    torch.cuda.empty_cache()

    # -- config 4: standardize + the T=300 forward trajectory at B=256
    from protstruc_tpu_torch.ops import diffusion as td

    rep = CFG4_B // sb8.batch_size
    sb4 = pt.StructureBatch.from_xyz(torch.nan_to_num(sb8.xyz).repeat(rep, 1, 1, 1),
                                     sb8.atom_mask.repeat(rep, 1, 1), device=dev)
    betas = td.cosine_variance_schedule(CFG4_T, device=dev)
    g = torch.Generator(device=dev)
    std_b = sb4.standardize()
    std_cpu = sb4.to("cpu").standardize()
    err_s = max(compare(std_cpu.xyz, std_b.xyz, "config 4 standardized xyz", COORD_ATOL, COORD_RTOL)[0],
                compare(std_cpu.mu, std_b.mu, "config 4 mu", COORD_ATOL, COORD_RTOL)[0],
                compare(std_cpu.std, std_b.std, "config 4 std", COORD_ATOL, COORD_RTOL)[0])
    captured = []

    def noise():
        for _ in range(CFG4_T):
            e = torch.randn(std_b.xyz.shape, generator=g, device=dev)
            captured.append(e[:CFG4_CPU_ROWS].cpu())
            yield e

    g.manual_seed(1)
    x_t = td._diffusion_trajectory(std_b.xyz, noise(), betas)
    g.manual_seed(1)
    check(torch.equal(td.diffusion_trajectory(std_b.xyz, betas, generator=g), x_t),
          "config 4: diffusion_trajectory differs from its core on the same draws")
    ref = td._diffusion_trajectory(std_cpu.xyz[:CFG4_CPU_ROWS], captured, betas.cpu())
    err_t = compare(ref, x_t[:CFG4_CPU_ROWS], "config 4 trajectory", COORD_ATOL, COORD_RTOL)[0]
    del captured
    sd, mean = float(x_t.std()), float(x_t.mean())
    check(abs(sd - 1.0) < 0.1 and abs(mean) < 0.05, f"config 4: x_T std {sd}, mean {mean}")

    def cfg4():
        g.manual_seed(1)
        return td.diffusion_trajectory(sb4.standardize().xyz, betas, generator=g)

    ms = cuda_time_ms(cfg4)
    say(f"phase 19 config 4 [{smi}]: standardize + diffusion_trajectory B={CFG4_B} L={sb4.n_residues} "
        f"T={CFG4_T} {ms:.4f} ms ({ms / CFG4_T * 1e3:.2f} us/step); standardize vs CPU {err_s:.3e}, "
        f"x_T of structures 0-{CFG4_CPU_ROWS - 1} vs CPU on the same draws {err_t:.3e}; x_T std {sd:.4f}, "
        f"mean {mean:.2e}")
    del sb4, std_b, std_cpu, x_t, ref
    torch.cuda.empty_cache()

    # -- config 5: B=1024 x L=1024 torsions -> NeRF -> actual CB -> A=15 -> K1 d_cb only
    from protstruc_tpu_torch.ops.nerf import backbone_from_dihedrals

    tor = config5_torsions(np)
    pt.StructureBatch.from_dihedrals(tor[:2, :8], device=dev)  # warm-up
    reset_launches(pair_maps)
    t0 = time.perf_counter()
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    start.record()
    sb5, cb, xyz15 = config5_xyz(torch, pt, tor, dev)
    mid.record()
    d_cb = pair_maps.pairwise_maps_forward(xyz15, maps=("d_cb",))
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = pair_maps.LAUNCHES
    check(launches == 1 and tuple(d_cb) == ("d_cb",), f"config 5: K1 launches {launches}, maps {tuple(d_cb)}")
    nerf_ms, k1_first_ms = start.elapsed_time(mid), mid.elapsed_time(end)
    d_cb = d_cb["d_cb"]

    x_cpu = backbone_from_dihedrals(torch.from_numpy(tor))[:, :, :3].double()
    x_64 = backbone_from_dihedrals(torch.from_numpy(tor).double())[:, :, :3]
    card = sb5.xyz[:, :, :3].cpu().double()
    check(bool(torch.isfinite(card).all()), "config 5: NeRF coordinates not finite")
    by_res = [(card - x_cpu).abs().amax(dim=(0, 2, 3)), (card - x_64).abs().amax(dim=(0, 2, 3)),
              (x_cpu - x_64).abs().amax(dim=(0, 2, 3))]
    err_card, err_cpu = float(by_res[1].max()), float(by_res[2].max())
    say(f"phase 19 config 5 NeRF [{smi}]: from_dihedrals B={CFG5_B} L={CFG5_L} {nerf_ms:.1f} ms "
        f"(CUDA events, with the CB and A=15 layout; the loop is host-bound: about 100 small ops a residue); "
        "max err by residue (card vs CPU port / card vs float64 / CPU vs float64) "
        + ", ".join(f"{r}: {float(by_res[0][r]):.2e} / {float(by_res[1][r]):.2e} / {float(by_res[2][r]):.2e}"
                    for r in NERF_RESIDUES)
        + f"; gate: card within 2x the CPU's distance from float64 + 1e-5 A ({err_card:.3e} vs {err_cpu:.3e})")
    check(err_card <= 2 * err_cpu + 1e-5,
          f"config 5: the card's NeRF chain is {err_card:.3e} from float64, the CPU's {err_cpu:.3e}")
    del x_cpu, x_64, card

    rows = list(CFG5_PLAIN_ROWS)
    plain = pair_maps._pair_maps_plain(xyz15[rows], maps=("d_cb",))["d_cb"]
    n_bad = unequal(plain, d_cb[rows])
    check(n_bad == 0, f"config 5: K1 d_cb differs from its plain version at {n_bad} entries")
    err = float((plain - d_cb[rows]).abs().nan_to_num().max())
    del plain
    k1_subset_writes(torch, pair_maps, xyz15, ("d_cb",), torch.float32)   # the whole batch
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(d_cb).all()), "config 5: d_cb not finite")
    # the library call for the same function: d_cb is |CB_i - CB_j| over the CB slot; its
    # matmul form (|a|^2 + |b|^2 - 2 a.b) is faster and rounds differently
    cb_slot = xyz15[:, :, 4]

    def library(mode="donot_use_mm_for_euclid_dist"):
        return torch.cdist(cb_slot, cb_slot, compute_mode=mode)

    lib_err = compare(d_cb, library(), "config 5 cdist d_cb")[0]
    mm_err = float((library("use_mm_for_euclid_dist") - d_cb).abs().max())
    torch.cuda.empty_cache()
    chunk = CFG5_B // CFG5_PLAIN_CALLS
    kernel = lambda: pair_maps.pairwise_maps_forward(xyz15, maps=("d_cb",))  # noqa: E731
    ms_plain, ms_k1, _ = alternate(
        lambda: [pair_maps._pair_maps_plain(xyz15[i:i + chunk], maps=("d_cb",))
                 for i in range(0, CFG5_B, chunk)], kernel)
    ms_lib = event_ms(torch, library, reps=1)   # over a second a call
    ms_mm = event_ms(torch, lambda: library("use_mm_for_euclid_dist"), reps=ITERS)
    out_bytes = d_cb.numel() * d_cb.element_size()
    b = bound(slot_bytes(xyz15, 1) + out_bytes, 8 * d_cb.numel(), torch.float32)
    b_all_xyz = (nbytes(xyz15) + out_bytes) / HBM_BYTES_PER_S * 1e3
    say(f"phase 19 config 5 K1 d_cb only [{smi}]: B={CFG5_B} L={CFG5_L} ({d_cb.numel()} pairs, "
        f"{out_bytes / 1e9:.2f} GB out, {pair_maps.tile_plan(CFG5_B, CFG5_L).n_tiles} tiles) kernel {ms_k1:.4f} ms "
        f"(first call {k1_first_ms:.4f}), plain {ms_plain:.4f} ms ({CFG5_PLAIN_CALLS} calls of {chunk}); "
        f"library torch.cdist over the CB slot {ms_lib:.4f} ms (within {lib_err:.3e} of K1; its matmul "
        f"form {ms_mm:.4f} ms, within {mm_err:.3e}); "
        f"bound {b[0]:.4f} ms ({b[1]}: the CB slot in, d_cb out; {b_all_xyz:.4f} ms reading all of xyz), "
        f"{b[0] / ms_k1 * 100:.1f}% of it; launches {launches}; bitwise equal to the plain version on "
        f"structures {rows[0]}-{rows[7]} and {rows[8]}-{rows[-1]}, only d_cb written over the whole batch "
        f"(sentinel planes); host {host_s:.2f} s for the path")
    dcb_entry = {"launches": launches, "max_abs_err": err, "unequal_vs_plain": n_bad, "ms": ms_k1,
                 "plain_ms": ms_plain, "bound_ms": b[0], "bound_by": b[1], "library_ms": ms_lib,
                 "shape": [CFG5_B, CFG5_L, CFG5_L]}
    del d_cb, xyz15, sb5, cb
    torch.cuda.empty_cache()

    # -- the reconstruction path: K1's six maps -> distmat -> MDS
    from protstruc_tpu_torch.ops import reconstruct as trec

    def reconstruct(b):
        g6 = b.inter_residue_geometry(use_kernel=True)
        ci = b.chain_idx[0]
        dist = trec.reconstruct_backbone_distmat_from_interresidue_geometry(
            g6["d_cb"][0], g6["omega"][0], g6["theta"][0], g6["phi"][0], mask=g6["d_cb_mask"][0],
            chain_break_mask=ci[1:] != ci[:-1])
        return dist, trec.initialize_backbone_with_mds(dist, max_iter=MDS_ITERS)

    def ca_rms(coords, b):
        ca, true = coords[1].double(), b.xyz[0, :, 1].double()
        m = b.get_residue_mask()[0]
        pair = m[:, None] & m[None]
        return float(((torch.cdist(ca, ca) - torch.cdist(true, true))[pair] ** 2).mean().sqrt())

    for name, gate in RECONSTRUCT:
        p = str(DATA / name)
        b, b_cpu = pt.StructureBatch.from_pdb(p, device=dev), pt.StructureBatch.from_pdb(p, device="cpu")
        reset_launches(pair_maps)
        t0 = time.perf_counter()
        dist, coords = reconstruct(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_r = pair_maps.LAUNCHES
        check(launches_r >= 1, f"reconstruction {name}: K1 not launched")
        dist_cpu, coords_cpu = reconstruct(b_cpu)
        err_dist = compare(dist_cpu, dist, f"reconstruction {name} distmat", COORD_ATOL, COORD_RTOL)[0]
        fit = proper_fit(coords, coords_cpu)
        check(fit < MDS_FIT_ATOL, f"reconstruction {name}: card MDS off the CPU's by {fit:.3e} after the fit")
        rms, rms_cpu = ca_rms(coords, b), ca_rms(coords_cpu, b_cpu)
        check(rms < gate, f"reconstruction {name}: CA distance-matrix RMS {rms:.3f} >= {gate}")
        ms = event_ms(torch, lambda: reconstruct(b), reps=1)
        say(f"phase 19 reconstruction {name} (L={b.n_residues}) [{smi}]: inter_residue_geometry(use_kernel=True) "
            f"-> distmat -> MDS ({MDS_ITERS} SMACOF iterations) {ms:.1f} ms (first call {wall * 1e3:.1f} ms wall); "
            f"K1 launches {launches_r}; CA distance-matrix RMS vs native {rms:.4f} A (CPU {rms_cpu:.4f}; gate "
            f"{gate}); distmat vs CPU {err_dist:.3e}, MDS coordinates vs CPU after a proper Kabsch fit {fit:.3e}")

    # -- renumber through the CLI, the renumbered file ingested on the card and on the CPU
    from protstruc_tpu_torch.__main__ import main as cli

    with tempfile.TemporaryDirectory() as tmp:
        out_pdb = str(pathlib.Path(tmp) / "6dc4_imgt.pdb")
        line, _ = run_cli(cli, ["renumber", ab_path, out_pdb, "--heavy", "H", "--light", "L", "--to", "imgt"])
        rep = json.loads(line)
        check(rep["chains"] == {"H": {"from": "chothia", "to": "imgt"}, "L": {"from": "chothia", "to": "imgt"}},
              f"renumber: {line.strip()}")
        got = pt.AntibodyStructureBatch.from_pdb(out_pdb, "H", "L", numbering_scheme="imgt", device=dev)
        want = pt.AntibodyStructureBatch.from_pdb(out_pdb, "H", "L", numbering_scheme="imgt", device="cpu")
        direct = pt.AntibodyStructureBatch.from_pdb(ab_path, "H", "L", numbering_scheme="imgt", device="cpu")
        for k, v in want.residue_masks.items():
            compare(v, got.residue_masks[k], f"renumber mask {k}")
        counts = {k: int((got.get_cdr_mask(k) & got.residue_mask).sum()) for k in pt.CDR_NAMES}
        direct_counts = {k: int((direct.get_cdr_mask(k) & direct.residue_mask).sum()) for k in pt.CDR_NAMES}
        check(counts == direct_counts, f"renumber: CDR sizes {counts} != {direct_counts}")
    say(f"phase 19 renumber: ok; {line.strip()}; the IMGT file's masks on the card equal the CPU's, "
        f"CDR sizes {counts} as the Chothia file converted at ingest")
    return dcb_entry


# -- the design and generation path (phase 20) -----------------------------------
# experiments/r5_flash_if_ab.py:27-45: the repo's own A/B of flash attention in
# InverseFold: bf16, D=256, P=32, 8 heads (dh 32), 3 encoder and 3 decoder
# blocks, B=1, the teacher-forced AR train step; here on 8gpi's first 2048
# residues (real backbones, 178 of them missing)
IF_WIDTH = dict(node_dim=256, pair_dim=32, n_heads=8, n_blocks=3, n_decoder_blocks=3)
IF_L, IF_STEPS, AR_L = 2048, 3, 256
FD_B, FD_L = 8, 128                # FrameDiffConfig's defaults on B=8, L=128
STAGE_ATOL = 1e-4                  # card vs CPU: FrameDiff, IF logits (f32), pack energies (rel)
CHI_ATOL = 1e-5                    # chi_angles and build_sidechains, card vs CPU
# idealize_backbone's Adam divides each coordinate's step by its own gradient
# scale, so rounding noise on a near-0 gradient entry becomes a +-lr step:
# 1.2e-3 A from the loss's reduction order alone on the CPU
# (tests/test_torch_idealize_predict.py)
IDEALIZE_ATOL = 2e-3
# predict_structure's whole decode after a proper fit: its idealize stage
# moves a coordinate by up to lr = 1e-2 A a step on the sign of its
# gradient, so its end is fixed to within that step (the phase reports the
# CPU's own spread from heads off by 1e-6 relative)
DECODE_ATOL = 1e-2
EXAMPLES = (("design_pipeline", "1REX.pdb"), ("design_cdr", "6dc4.pdb"),
            ("framediff_backbones", "1REX.pdb"), ("generate_backbones", "1REX.pdb"),
            ("reconstruct_pipeline", "1REX.pdb"))


def proper_fit(coords, ref) -> float:
    """Largest coordinate error of ``coords`` (any device) against ``ref``
    (CPU) after a Kabsch fit in float64; fails on a mirror image."""
    import torch
    from protstruc_tpu_torch.geometry import kabsch

    a, b = coords.detach().cpu().reshape(-1, 3).double(), ref.reshape(-1, 3).double()
    rot, t = kabsch(a, b)
    check(float(torch.linalg.det(rot)) > 0, "the card's coordinates are a mirror image of the CPU's")
    return float((a @ rot.T + t - b).abs().max())


def map_heads(sb, cfg):
    """TrFold heads that carry ``sb``'s own 6D maps (B = 1): each distogram
    row a Gaussian one bin wide about the true d_cb, each angle as (sin,
    cos); with the pair mask of ``featurize_for_model``."""
    import torch
    g = sb.inter_residue_geometry()
    w = cfg.max_dist / cfg.n_dist_bins
    centers = (torch.arange(cfg.n_dist_bins, dtype=torch.float32) + 0.5) * w
    out = {"distogram_logits": -((centers - g["d_cb"].nan_to_num(0)[..., None]) / w) ** 2 / 2}
    for k in ("omega", "theta", "phi"):
        a = g[k].nan_to_num(0)
        out[f"{k}_sincos"] = torch.stack([torch.sin(a), torch.cos(a)], -1)
    return out, g["d_cb_mask"] & torch.isfinite(g["d_cb"])


def design_inputs(dev):
    """8gpi's backbone features cut to IF_L residues, with its sequence as the
    target, on ``dev``."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.models.inverse_fold import featurize_backbone

    f = featurize_backbone(pt.StructureBatch.from_pdb(str(DATA / "8gpi.pdb"), device=dev))
    cut = {}
    for k, v in f.items():
        v = v[:, :IF_L]
        cut[k] = v[:, :, :IF_L] if k in ("d_ca", "d_mask") else v
    return cut


def if_models(torch, dev, flash_paths=(True, False)):
    """The full-width AR InverseFold, flash and einsum paths, on one init."""
    from protstruc_tpu_torch.models.inverse_fold import InverseFold, InverseFoldConfig

    models = {}
    for flash in flash_paths:
        m = InverseFold(InverseFoldConfig(**IF_WIDTH, dtype=torch.bfloat16, use_flash_attn=flash),
                        device=dev)
        if models:
            m.load_state_dict(next(iter(models.values())).state_dict())
        else:
            m.reset_parameters(torch.Generator(dev).manual_seed(0))
        models[flash] = m
    return models


def if_stepper(model, feats, rank):
    """One teacher-forced AR train step (loss, backward, AdamW) from the
    model's parameters as they stand; returns the loss, detached."""
    from protstruc_tpu_torch.models.inverse_fold import _if_ar_loss
    from protstruc_tpu_torch.models.trfold import adamw

    params = dict(model.named_parameters())
    opt = adamw(params.values(), 1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = _if_ar_loss(params, model, feats, rank)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def folded_causal_bias(torch, fa, dev, rank, smi):
    """(b) K8/K9 against their plain versions at the IF shape (bf16, B=1,
    H=8, dh=32, L=IF_L) on the folded causal bias, the k/v stream a second
    projection; the rows with no allowed key post-zeroed."""
    gen = torch.Generator(dev).manual_seed(20)
    B, H, dh, L = 1, IF_WIDTH["n_heads"], IF_WIDTH["node_dim"] // IF_WIDTH["n_heads"], IF_L
    bf = torch.bfloat16
    qkv = torch.randn((B, L, 3, H, dh), generator=gen, device=dev).to(bf)
    kv3 = torch.randn((B, L, 3, H, dh), generator=gen, device=dev).to(bf)
    q, k, v = qkv[:, :, 0], kv3[:, :, 1], kv3[:, :, 2]
    check(k.stride() == q.stride() and k.stride(-1) == 1, f"kv strides {k.stride()} vs q {q.stride()}")
    bias = torch.randn((B, L, L, H), generator=gen, device=dev).to(bf).permute(0, 3, 1, 2)
    causal = rank[:, None, :] < rank[:, :, None]
    kmask = torch.ones((B, L), dtype=torch.bool, device=dev)
    kmask[:, -37:] = False  # a padded tail
    fbias = (bias.float() + torch.where(causal[:, None], 0.0, -1e9)).to(bf)
    no_row = ~(causal & kmask[:, None, :]).any(-1)  # (B, L): the rank-0 row, at least
    check(bool(no_row.any()), "no query row without an allowed key")
    out, lse = fa.flash_fwd(q, k, v, fbias, kmask)
    torch.cuda.synchronize()
    r_out, r_lse = fa._flash_fwd_plain(q, k, v, fbias, kmask)
    do = torch.randn((B, L, H, dh), generator=gen, device=dev).to(bf)
    do = torch.where(no_row[:, :, None, None], 0.0, do).to(bf)  # the post-zero's cotangent
    delta = (do.float() * r_out.float()).sum(-1).permute(0, 2, 1).contiguous()
    ds, dk, dv = fa.flash_bwd(q, k, v, fbias, kmask, do, r_lse, delta)
    torch.cuda.synchronize()
    r_ds, r_dk, r_dv = fa._flash_bwd_plain(q, k, v, fbias, kmask, do, r_lse, delta)
    live = (~no_row)[:, None, :].expand_as(r_lse)
    errs = {"out": flash_budget(torch, r_out[~no_row], out[~no_row], "folded out", "out"),
            "lse": flash_budget(torch, r_lse, lse, "folded lse", "lse", live),
            "ds": flash_budget(torch, r_ds, ds, "folded ds", "ds"),
            "dk": flash_budget(torch, r_dk, dk, "folded dk", "dk"),
            "dv": flash_budget(torch, r_dv, dv, "folded dv", "dv")}
    check(bool((ds.permute(0, 2, 1, 3)[no_row] == 0).all()), "ds of a post-zeroed row is not 0")
    # the post-zeroed rows add exactly nothing to dk and dv: replacing their q
    # and their bias rows leaves both bitwise unchanged (K9 from K8's lse both times)
    _, dk1, dv1 = fa.flash_bwd(q, k, v, fbias, kmask, do, lse, delta)
    q2 = torch.where(no_row[:, :, None, None], 7.0, q.float()).to(bf)
    f2 = fbias.clone()
    f2.permute(0, 2, 1, 3)[no_row] = -3.0e4
    _, lse2 = fa.flash_fwd(q2, k, v, f2, kmask)
    _, dk2, dv2 = fa.flash_bwd(q2, k, v, f2, kmask, do, lse2, delta)
    check(torch.equal(dk2, dk1) and torch.equal(dv2, dv1),
          "dk/dv moved when the post-zeroed rows' q and bias changed")
    n_rows = int(no_row.sum())
    say(f"phase 20 (b) folded causal bias K8/K9 vs plain bf16 B={B} H={H} dh={dh} L={L} [{smi}]: "
        + ", ".join(f"{key} {e:.2e} ({rel:.2e} of max|ref|)" for key, (e, rel) in errs.items())
        + f"; {n_rows} rows without an allowed key: ds exactly 0, dk and dv bitwise unchanged "
          f"with their q and bias replaced")
    return {"fwd": max(errs["out"][0], errs["lse"][0]),
            "bwd": max(errs[key][0] for key in ("ds", "dk", "dv"))}


def card_vs_cpu(torch, dev, smi):
    """(c) Each design stage on the card against the port on the CPU, from
    the same inputs and the same draws, made on the host and copied."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.examples import fragments
    from protstruc_tpu_torch.models import framediff as fd
    from protstruc_tpu_torch.models import inverse_fold as tif
    from protstruc_tpu_torch.models.ipa import frames_from_backbone
    from protstruc_tpu_torch.models.trfold import (TrFold, TrFoldConfig, _decode_structure, _mds_backbone,
                                                     featurize_for_model, predict_structure)
    from protstruc_tpu_torch.ops import chi, graft, pack
    from protstruc_tpu_torch.ops.idealize import idealize_backbone
    from protstruc_tpu_torch.ops.so3 import igso3_draws

    cpu = torch.device("cpu")
    host = torch.Generator().manual_seed(21)
    res = {}

    def both(fn, *args):
        """``fn`` on the CPU, then on the card with every tensor argument copied."""
        def move(a):
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            if isinstance(a, (tuple, list)):
                return type(a)(move(x) for x in a)
            if isinstance(a, dict):
                return {k: move(x) for k, x in a.items()}
            return a
        return fn(*args), fn(*move(args))

    def err(ref, got, rel=False):
        ref, got = ref.float(), got.detach().cpu().float()
        check(torch.equal(torch.isnan(ref), torch.isnan(got)), "NaN patterns differ")
        d = float((ref - got).abs().nan_to_num(0).max())
        return d / max(float(ref.abs().nan_to_num(0).max()), 1e-30) if rel else d

    # FrameDiff at the design example's width, on 1REX's fragments
    sb = pt.StructureBatch.from_pdb(str(DATA / "1REX.pdb"), device=cpu)
    frags = torch.from_numpy(fragments(sb.xyz[0, :, :4].numpy(), 32))
    cfg = fd.FrameDiffConfig(node_dim=48, pair_dim=24, n_heads=4, n_iter=1, T=48)
    ca = frags[:, :, 1]
    center = ca.mean(1, keepdim=True)
    x0 = (ca - center) / cfg.trans_scale
    r0, _ = frames_from_backbone(frags - center[:, :, None])
    mask = torch.ones(x0.shape[:2], dtype=torch.bool)
    models = {d: fd.FrameDenoiser(cfg, device=d) for d in (cpu, dev)}
    models[cpu].reset_parameters(host)
    models[dev].load_state_dict(models[cpu].state_dict())
    B, L = x0.shape[:2]
    t = torch.randint(0, cfg.T, (B,), generator=host)
    eps = torch.randn(x0.shape, generator=host)
    rot = igso3_draws((B, L), host)
    losses = {}
    for d, m in models.items():
        move = (lambda a: a.to(d))
        losses[d] = fd._framediff_loss(dict(m.named_parameters()), m, move(r0), move(x0), move(mask),
                                       cfg, move(t), move(eps), tuple(map(move, rot)))
    lc, ld = float(losses[cpu].detach()), float(losses[dev].detach())
    res["framediff loss"] = abs(lc - ld) / abs(lc)
    x_T = torch.randn((2, 32, 3), generator=host)
    rT = igso3_draws((2, 32), host)
    step = [(torch.randn((2, 32, 3), generator=host), igso3_draws((2, 32), host))]
    outs = {}
    for d, m in models.items():
        move = (lambda a: a.to(d))
        outs[d] = fd._framediff_sample(dict(m.named_parameters()), m, cfg, move(x_T),
                                       tuple(map(move, rT)),
                                       [(move(step[0][0]), tuple(map(move, step[0][1])))])
    res["framediff step r"] = err(outs[cpu][0], outs[dev][0])
    res["framediff step x"] = err(outs[cpu][1], outs[dev][1])

    # InverseFold logits, f32, on 1REX: the einsum path and the flash path (K8
    # on the card, its plain version on the CPU); the example's width with 64
    # node channels, so the 4 heads are 16 wide (K8 takes dh 16, 32, 64, 128)
    f_cpu = tif.featurize_backbone(sb)
    Lr = f_cpu["residue_mask"].shape[1]
    perm = torch.stack([torch.randperm(Lr, generator=host)])
    f_cpu = dict(f_cpu, prev_seq=f_cpu["target_seq"], decode_rank=tif._ranks(perm))
    for flash in (False, True):
        icfg = tif.InverseFoldConfig(node_dim=64, pair_dim=24, n_heads=4, n_blocks=1,
                                     n_decoder_blocks=1, use_flash_attn=flash)
        ims = {d: tif.InverseFold(icfg, device=d) for d in (cpu, dev)}
        ims[cpu].reset_parameters(torch.Generator().manual_seed(3))
        ims[dev].load_state_dict(ims[cpu].state_dict())
        with torch.no_grad():
            ref = ims[cpu](f_cpu)
            got = ims[dev]({k: v.to(dev) for k, v in f_cpu.items()})
        res[f"IF logits {'flash' if flash else 'einsum'}"] = err(ref, got)
    # the AR-sampled sequence on the same permutation and Gumbel noise
    gumbel = -torch.log(-torch.log(torch.rand((Lr, 1, 21), generator=host).clamp_min(1e-38)))
    seqs = {}
    for d, m in ims.items():
        f = {k: v.to(d) for k, v in f_cpu.items()}
        seqs[d] = tif._ar_sample_sequence(dict(m.named_parameters()), m, f, perm.to(d),
                                          gumbel.to(d), 0.2).cpu()
    check(torch.equal(seqs[cpu], seqs[dev]),
          f"AR sequence differs at {int((seqs[cpu] != seqs[dev]).sum())} positions")
    res["AR sequence (positions differing)"] = 0

    # chi angles, grafting and packing on 1REX and 4EOT
    sb2 = pt.StructureBatch.from_pdb([str(DATA / "1REX.pdb"), str(DATA / "4EOT.pdb")], device=cpu)
    xyz, seq, am = sb2.xyz, sb2.get_seq_idx(), sb2.atom_mask
    (c_ref, m_ref), (c_got, m_got) = both(chi.chi_angles, xyz, seq, am)
    check(torch.equal(m_ref, m_got.cpu()), "chi masks differ")
    res["chi_angles"] = err(c_ref, c_got)
    lib = graft.sidechain_library(sb2)
    design_seq = torch.randint(0, 20, seq.shape, generator=host, dtype=torch.int32)
    (g_ref, gm_ref), (g_got, gm_got) = both(graft.build_sidechains, xyz[:, :, :5], design_seq, lib,
                                            sb2.residue_mask)
    check(torch.equal(gm_ref, gm_got.cpu()), "build_sidechains masks differ")
    res["build_sidechains"] = err(g_ref, g_got)
    Lp = 64
    start = g_ref[:1, :Lp]  # grafted side chains: they clash
    noise = torch.randn((10, 6, 1, Lp, 4), generator=host)
    (_, e_ref), (_, e_got) = both(pack._pack_sidechains, start, design_seq[:1, :Lp], gm_ref[:1, :Lp], noise)
    res["pack energies (rel)"] = err(e_ref, e_got, rel=True)

    # predict_structure: the forward it decodes, on a random-init TrFold
    tms = {d: TrFold(TrFoldConfig(), device=d) for d in (cpu, dev)}
    tms[cpu].reset_parameters(torch.Generator().manual_seed(4))
    tms[dev].load_state_dict(tms[cpu].state_dict())
    feats = {d: featurize_for_model(sb.to(d)) for d in (cpu, dev)}
    with torch.no_grad():
        heads = {d: m(feats[d]) for d, m in tms.items()}
    res["predict_structure heads"] = max(err(heads[cpu][k], heads[dev][k]) for k in (
        "distogram_logits", "omega_sincos", "theta_sincos", "phi_sincos"))
    coords, _ = predict_structure(dict(tms[dev].named_parameters()), tms[dev], feats[dev])
    check(coords.shape == (5, Lr, 3) and bool(torch.isfinite(coords).all()),
          f"predict_structure on the card: {tuple(coords.shape)}, finite {bool(torch.isfinite(coords).all())}")
    # ... and its decode, on heads that carry 1REX's own maps: a random
    # model's distogram is near uniform, its distance matrix near degenerate
    # (MDS of one such matrix lands 3.4e-3 A apart on the two devices)
    out, pm = map_heads(sb, TrFoldConfig())
    (m_ref, p_ref), (m_got, p_got) = both(lambda o, m: _mds_backbone(o, m, TrFoldConfig()), out, pm)
    res["decode d_cb"] = err(p_ref["d_cb"], p_got["d_cb"])
    res["decode angles (rad)"] = max(
        float((torch.remainder(p_got[k].cpu() - p_ref[k] + math.pi, 2 * math.pi) - math.pi).abs().max())
        for k in ("omega", "theta", "phi"))
    res["decode MDS (fit)"] = proper_fit(m_got, m_ref)
    # idealize_backbone from the CPU's MDS coordinates on both devices
    (i_ref, _), (i_got, _) = both(lambda c: idealize_backbone(c, n_steps=150),
                                  m_ref[:4].transpose(0, 1).contiguous())
    res["idealize_backbone"] = err(i_ref, i_got)
    (c_ref, _), (c_got, _) = both(lambda o, m: _decode_structure(o, m, TrFoldConfig()), out, pm)
    res["decode coordinates (fit)"] = proper_fit(c_got, c_ref)
    # the decode's own spread: the CPU again, on heads off by 1e-6 relative
    noisy = {k: v * (1 + 1e-6 * torch.randn(v.shape, generator=host)) for k, v in out.items()}
    spread = proper_fit(_decode_structure(noisy, pm, TrFoldConfig())[0], c_ref)

    limits = {"framediff loss": STAGE_ATOL, "framediff step r": STAGE_ATOL,
              "framediff step x": STAGE_ATOL, "IF logits einsum": STAGE_ATOL,
              "IF logits flash": STAGE_ATOL, "AR sequence (positions differing)": 0,
              "chi_angles": CHI_ATOL, "build_sidechains": CHI_ATOL,
              "pack energies (rel)": STAGE_ATOL, "predict_structure heads": STAGE_ATOL,
              "decode d_cb": STAGE_ATOL, "decode angles (rad)": CHI_ATOL,
              "decode MDS (fit)": MDS_FIT_ATOL, "idealize_backbone": IDEALIZE_ATOL,
              "decode coordinates (fit)": DECODE_ATOL}
    say(f"phase 20 (c) stages, card vs CPU [{smi}]: "
        + "; ".join(f"{k} {v:.3e} (limit {limits[k]:.0e})" for k, v in res.items())
        + f"; reported: the decode on the CPU from heads off by 1e-6 relative {spread:.3e} A "
          "after a fit")
    for k, lim in limits.items():
        check(res[k] <= lim, f"phase 20 (c) {k}: card vs CPU {res[k]:.3e} > {lim:.0e}")
    return res


def design_phase(torch, dev, smi):
    """Phase 20: the design and generation path.  Returns the K8/K9 launches
    of one full-width IF train step on the flash path and the folded-bias
    errors, for the kernels line."""
    from protstruc_tpu_torch.models import framediff as fd
    from protstruc_tpu_torch.models import inverse_fold as tif
    from protstruc_tpu_torch.ops import flash_attn as fa
    from protstruc_tpu_torch.ops.rigid import random_rotations

    # -- (a) the IF train step at full width, flash against einsum -----------------
    feats = design_inputs(dev)
    rank = tif.random_decode_order((1, IF_L), torch.Generator(dev).manual_seed(1))
    models = if_models(torch, dev)
    init = {k: v.detach().clone() for k, v in models[True].state_dict().items()}
    steppers = {flash: if_stepper(m, feats, rank) for flash, m in models.items()}
    losses, launches = {}, {}
    for flash, step in steppers.items():
        reset_launches(fa)
        losses[flash] = [float(step()) for _ in range(IF_STEPS)]
        torch.cuda.synchronize()
        launches[flash] = {k: v / IF_STEPS for k, v in fa.LAUNCHES.items()}
    check(all(math.isfinite(x) for ls in losses.values() for x in ls), f"IF losses {losses}")
    check(launches[True]["fwd"] > 0 and launches[True]["bwd"] > 0, "the IF step launched K8/K9 no time")
    check(launches[False] == {"fwd": 0, "bwd": 0}, f"the einsum path launched {launches[False]}")
    compare_losses(losses[True], losses[False], 2e-2, f"IF bf16 B=1 L={IF_L}")
    step_ms, peak, busy = {}, {}, {}
    for flash, m in models.items():
        m.load_state_dict(init)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        steppers[flash]()
        torch.cuda.synchronize()
        peak[flash] = torch.cuda.max_memory_allocated() / 2**30
        step_ms[flash] = cuda_time_ms(steppers[flash])
        busy[flash] = device_profile(torch, steppers[flash])
    for flash in (True, False):
        wall, dev_ms, top = busy[flash]
        say(f"phase 20 (a) profile IF train step, {'flash' if flash else 'einsum'} path, one step under "
            f"torch.profiler: device busy {dev_ms:.2f} of {wall:.2f} ms wall (idle "
            f"{100 * (1 - dev_ms / wall):.1f}%); top kernels "
            + "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for name, ms, n in top))
    say(f"phase 20 (a) IF train step bf16 B=1 L={IF_L} {IF_WIDTH} on 8gpi [{smi}]: flash "
        f"{step_ms[True]:.4f} ms/step (peak {peak[True]:.2f} GiB), einsum {step_ms[False]:.4f} ms/step "
        f"(peak {peak[False]:.2f} GiB); losses flash {losses[True]}, einsum {losses[False]}; K8/K9 "
        f"launches a step {launches[True]}")
    del steppers, models, init
    torch.cuda.empty_cache()

    # -- (b) K8/K9 on the folded causal bias at that shape -------------------------
    folded = folded_causal_bias(torch, fa, dev, rank, smi)

    # -- (c) stage by stage, card against CPU ------------------------------------------
    card_vs_cpu(torch, dev, smi)

    # -- (d) speeds ---------------------------------------------------------------------
    model = if_models(torch, dev, (True,))[True]
    f = {k: (v[:, :AR_L, :AR_L] if k in ("d_ca", "d_mask") else v[:, :AR_L]) for k, v in feats.items()}
    params = dict(model.named_parameters())
    gen = torch.Generator(dev).manual_seed(2)
    tif.ar_sample_sequence(params, model, f, temperature=0.1, generator=gen)  # warm-up
    reset_launches(fa)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    seq = tif.ar_sample_sequence(params, model, f, temperature=0.1, generator=gen)
    end.record()
    torch.cuda.synchronize()
    ar_ms = start.elapsed_time(end) / AR_L
    check(bool(((seq < 20) == f["residue_mask"]).all()), "AR sample: UNK at a valid position")
    say(f"phase 20 (d) ar_sample_sequence bf16 L={AR_L} {IF_WIDTH} flash [{smi}]: {ar_ms:.4f} ms per "
        f"decoded position ({AR_L} positions); K8 launches {fa.LAUNCHES['fwd']}")
    del model, params, feats, f
    cfg = fd.FrameDiffConfig()
    den = fd.FrameDenoiser(cfg, device=dev)
    den.reset_parameters(torch.Generator(dev).manual_seed(3))
    fparams = dict(den.named_parameters())
    gen = torch.Generator(dev).manual_seed(4)
    x0 = torch.randn((FD_B, FD_L, 3), generator=gen, device=dev)
    loss = fd.framediff_loss(fparams, den, random_rotations((FD_B, FD_L), gen), x0,
                             torch.ones((FD_B, FD_L), dtype=torch.bool, device=dev), cfg, generator=gen)
    loss.backward()
    check(math.isfinite(float(loss)), f"FrameDiff loss {float(loss)}")
    fd.framediff_sample(fparams, den, (FD_B, FD_L), cfg, generator=gen)  # warm-up (and the tables)
    start.record()
    r, x = fd.framediff_sample(fparams, den, (FD_B, FD_L), cfg, generator=gen)
    end.record()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(r).all() and torch.isfinite(x).all()), "framediff_sample: non-finite")
    say(f"phase 20 (d) framediff_sample B={FD_B} L={FD_L} FrameDiffConfig() T={cfg.T} [{smi}]: "
        f"{start.elapsed_time(end) / cfg.T:.4f} ms per reverse step; loss at that size "
        f"{float(loss):.4f}")
    del den, fparams, r, x, loss
    torch.cuda.empty_cache()

    # -- (e) the example drivers on the card at their own sizes ---------------------------
    import importlib
    import os

    for name, pdb in EXAMPLES:
        mod = importlib.import_module(f"protstruc_tpu_torch.examples.{name}")
        with tempfile.TemporaryDirectory() as tmp:
            cwd = os.getcwd()
            os.chdir(tmp)
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()) as log:
                    written = mod.main([str(DATA / pdb)])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                for f in written:
                    check(pathlib.Path(f).stat().st_size > 0, f"{name}: {f} is empty")
            finally:
                os.chdir(cwd)
        last = log.getvalue().strip().splitlines()[-2:]
        say(f"phase 20 (e) example {name} on {pdb}, default steps, on the card: {wall:.2f} s; "
            f"wrote {written}; {' | '.join(last)}")
    return {"launches": launches[True], "folded": folded}


# -- phase 21: the scale-out slice ---------------------------------------------
RECT_LENGTHS = (37, 300, 512)       # Lj % 4 != 0 (scalar stores) and == 0 (vector ones)
PEAK_WIDTH = dict(node_dim=2048, pair_dim=1024, n_heads=8, n_blocks=3, pair_update="triangle",
                  remat=True)        # bench.py:348-351 [mfu-peak]: bf16, B=2, L=256
PEAK_B, PEAK_L, PEAK_STEPS = 2, 256, 3
POLICIES = ("none", "tri_dots", "dots")
LSE_SHAPES = (("train", 4, 4, 32, 256), ("ragged", 2, 4, 32, 37))   # the ragged row 1 has no key
RING_N = 4


def row_blocks(L, n):
    """``n`` near-equal row blocks of ``L`` rows (empty ones dropped)."""
    edges = [round(i * L / n) for i in range(n + 1)]
    return [slice(a, b) for a, b in zip(edges, edges[1:]) if b > a]


def rect_subset_writes(torch, pair_maps, xi, xj, maps, dtype):
    """K1's rectangular entry with all six planes at a sentinel and ``maps``
    selected: those equal the wrapper's, the others keep every sentinel bit."""
    B, Li, A, _ = xi.shape
    Lj = xj.shape[1]
    lib = pair_maps.load_library()
    planes = {k: torch.full((B, Li, Lj), 7.0, dtype=dtype, device=xi.device) for k in pair_maps.MAP_NAMES}
    bits = sum(1 << pair_maps.MAP_NAMES.index(k) for k in maps)
    err = lib.ps_pair_maps_rect(xi.device.index, int(dtype == torch.bfloat16), xi.data_ptr(),
                                xj.data_ptr(), B, Li, Lj, A, bits,
                                *[planes[k].data_ptr() for k in pair_maps.MAP_NAMES],
                                pair_maps.plan_arg(pair_maps.tile_plan(B, Li, Lj)),
                                torch.cuda.current_stream(xi.device).cuda_stream)
    check(err == 0, f"K1 rect subset launch: CUDA error {err}")
    want = pair_maps.pairwise_maps_forward(xi, maps, out_dtype=dtype, xyz_j=xj)
    torch.cuda.synchronize()
    for k, p in planes.items():
        if k in maps:
            check(unequal(want[k], p) == 0, f"K1 rect subset {dtype}: {k} differs from the wrapper's")
        else:
            check(bool((p == 7.0).all()), f"K1 rect subset {dtype}: unselected {k} was written")


def rect_parity(torch, np, dev, pair_maps, smi):
    """Phase 21 (a): K1's rectangular mode bitwise against its plain version
    (B=2, L = 37, 300, 512 split into 1-4 row blocks, and the degenerate
    probes), map subsets into sentinel planes, bf16 planes = the f32 planes
    cast; then at B=256, L=512 four row blocks of 128 bitwise equal to the
    square launch's rows, the 4 launches timed against the square launch and
    the bound.  Returns the kernels-line numbers."""
    rng = np.random.RandomState(21)
    cases = {f"B2 L{L}": torch.from_numpy((rng.randn(2, L, 15, 3) * 10).astype(np.float32)).to(dev)
             for L in RECT_LENGTHS}
    cases["probes"] = probes(torch, dev)
    n_checked, worst = 0, 0.0
    for label, x in cases.items():
        L = x.shape[1]
        for n in (1, 2, 3, 4):
            for rows in row_blocks(L, n):
                xi = x[:, rows].contiguous()
                got = pair_maps.pairwise_maps_forward(xi, xyz_j=x)
                torch.cuda.synchronize()
                ref = pair_maps._pair_maps_plain(xi, xyz_j=x)
                k1_bitwise(ref, got, f"rect {label} rows {rows.start}:{rows.stop}")
                worst = max(worst, max(float((ref[k] - got[k]).abs().nan_to_num().max()) for k in ref))
                n_checked += 1
        xi = x[:, :max(L // 3, 1)].contiguous()
        for dt in (torch.float32, torch.bfloat16):
            rect_subset_writes(torch, pair_maps, xi, x, ("d_cb", "phi"), dt)
        f32 = pair_maps.pairwise_maps_forward(xi, xyz_j=x)
        b16 = pair_maps.pairwise_maps_forward(xi, out_dtype=torch.bfloat16, xyz_j=x)
        torch.cuda.synchronize()
        n_bad = sum(unequal(f32[k].to(torch.bfloat16), b16[k]) for k in f32)
        check(n_bad == 0, f"rect {label}: bf16 planes differ from the f32 planes cast at {n_bad} entries")
        say(f"  rect {label}: {store_path(L)} stores (Lj={L}), row blocks 1-4 bitwise equal to plain; "
            f"subset into sentinels ok (f32, bf16); bf16 = f32 cast")
    say(f"phase 21a parity K1 rectangular mode: ok, {n_checked} row blocks bitwise equal to the plain "
        f"version (max abs err {worst:.1e})")

    xyz = torch.from_numpy(np.random.RandomState(0).randn(B_FULL, L_FULL, 15, 3).astype(np.float32)
                           * 10).to(dev)
    blocks = [xyz[:, r].contiguous() for r in row_blocks(L_FULL, 4)]
    square = pair_maps.pairwise_maps_forward(xyz)
    n_bad = 0
    for r, xi in zip(row_blocks(L_FULL, 4), blocks):
        got = pair_maps.pairwise_maps_forward(xi, xyz_j=xyz)
        torch.cuda.synchronize()
        n_bad += sum(unequal(square[k][:, r].contiguous(), got[k]) for k in got)
        del got
    del square
    check(n_bad == 0, f"rect B={B_FULL}: row blocks differ from the square launch at {n_bad} entries")

    def four():
        for xi in blocks:
            pair_maps.pairwise_maps_forward(xi, xyz_j=xyz)

    def four_plain():
        for xi in blocks:
            pair_maps._pair_maps_plain(xi, xyz_j=xyz)

    square_ms = cuda_time_ms(lambda: pair_maps.pairwise_maps_forward(xyz))
    rect_ms = cuda_time_ms(four)
    square_ms2 = cuda_time_ms(lambda: pair_maps.pairwise_maps_forward(xyz))
    plain_ms = cuda_time_ms(four_plain)
    torch.cuda.empty_cache()
    # each launch reads its rows' atoms and all of xyz_j's, writes its rows
    rect_bound = bound(slot_bytes(xyz, K1_SLOTS) * 5 + 6 * B_FULL * L_FULL ** 2 * 4,
                       K1_OPS_PER_PAIR * B_FULL * L_FULL ** 2, torch.float32)
    say(f"phase 21a timing K1 rectangular B={B_FULL} L={L_FULL} as 4 row blocks of 128 [{smi}]: "
        f"{rect_ms:.4f} ms for the 4 launches, square launch {square_ms:.4f} / {square_ms2:.4f} ms "
        f"(before / after), plain 4 blocks {plain_ms:.4f} ms; bound {rect_bound[0]:.4f} ms "
        f"({rect_bound[1]}); the blocks bitwise equal to the square launch's rows")
    return {"err": worst, "ms": rect_ms, "plain_ms": plain_ms, "square_ms": (square_ms, square_ms2),
            "bound": rect_bound}


def lse_parity(torch, dev, flash_attn, ring_attn):
    """Phase 21 (b): the lse entry point (K8/K9) against the plain lse
    attention on the card, f32 and bf16, at the train shape and ragged L
    with a fully-masked row: out, lse (-inf exactly on that row), ds (the
    bias's gradient), dq, dk, dv for random cotangents of both outputs, with
    inf and NaN lse cotangents on the masked rows."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, H, dh, L in LSE_SHAPES:
            q, k, v, bias, kmask, do = flash_inputs(torch, dev, dtype, label, B, H, dh, L, seed=21)
            gen = torch.Generator(dev).manual_seed(22)
            g_lse = torch.randn((B, H, L), generator=gen, device=dev)
            dead = ~kmask.any(-1)
            rows = g_lse[dead]
            rows[..., 0::2] = float("inf")
            rows[..., 1::2] = float("nan")
            g_lse[dead] = rows
            res = {}
            for path in ("kernel", "plain"):
                ins = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
                if path == "kernel":
                    out, lse = flash_attn.flash_pair_bias_attention_lse(*ins, kmask)
                else:
                    out, lse = ring_attn.local_attention_lse(*ins, kmask, "plain")
                torch.autograd.backward([out, lse], [do, g_lse])
                torch.cuda.synchronize()
                res[path] = {"out": out.detach(), "lse": lse.detach(), "dq": ins[0].grad,
                             "dk": ins[1].grad, "dv": ins[2].grad, "ds": ins[3].grad}
            got, ref = res["kernel"], res["plain"]
            name = f"lse {label} {str(dtype)[6:]} B={B} H={H} dh={dh} L={L}"
            check(torch.equal(torch.isneginf(got["lse"]), torch.isneginf(ref["lse"]))
                  and torch.equal(torch.isneginf(got["lse"]), dead[:, None, None].expand_as(got["lse"])),
                  f"{name}: lse is -inf exactly on the rows without a key")
            live = ~dead[:, None, None].expand_as(ref["lse"])
            errs = {}
            errs["lse"] = flash_budget(torch, ref["lse"][live], got["lse"][live], f"{name} lse", "lse")
            for key in ("out", "ds", "dq", "dk", "dv"):
                errs[key] = flash_budget(torch, ref[key].to(got[key].dtype), got[key], f"{name} {key}", key)
            if bool(dead.any()):
                for key in ("out", "dq", "dk", "dv"):
                    check(bool((got[key][dead] == 0).all()), f"{name}: {key} of a row without a key not 0")
            say(f"  {name}: " + ", ".join(f"{key} {e:.2e} ({rel:.2e} of max|ref|)"
                                         for key, (e, rel) in errs.items()))
            worst["fwd"] = max(worst["fwd"], errs["out"][0], errs["lse"][0])
            worst["bwd"] = max(worst["bwd"], *(errs[key][0] for key in ("ds", "dq", "dk", "dv")))
    say(f"phase 21b parity lse entry point (K8/K9) vs the plain lse attention: ok, max abs err {worst}")
    return worst


def ring_merge_parity(torch, dev, flash_attn, ring_attn):
    """Phase 21 (c): the ring's attend-and-merge over n = 4 blocks on one
    card, each rank's visiting order, against flash_pair_bias_attention over
    the full L: out and the q, k, v, bias gradients (f32 and bf16)."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias, kmask, do = flash_inputs(torch, dev, dtype, "train", 4, 4, 32, 256, seed=23)
        kmask[0, 64:128] = False               # a whole block of structure 0 without a key
        ref_in = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        ref = flash_attn.flash_pair_bias_attention(*ref_in, kmask)
        ref.backward(do)
        mine = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        B, L, H, dh = q.shape
        Lq = L // RING_N
        outs = []
        for r in range(RING_N):
            rows = slice(r * Lq, (r + 1) * Lq)
            acc = torch.zeros((B, Lq, H, dh), dtype=torch.float32, device=dev)
            lse = torch.full((B, H, Lq), float("-inf"), device=dev)
            for t in range(RING_N):
                cols = slice(((r + t) % RING_N) * Lq, ((r + t) % RING_N + 1) * Lq)
                acc, lse = ring_attn.attend_merge(acc, lse, mine[0][:, rows], mine[1][:, cols],
                                                  mine[2][:, cols], mine[3][:, :, rows, cols],
                                                  kmask[:, cols], "flash")
            out = acc.to(dtype)
            out.backward(do[:, rows])
            outs.append(out.detach())
        torch.cuda.synchronize()
        name = f"ring merge n={RING_N} {str(dtype)[6:]} B={B} H={H} dh={dh} L={L}"
        errs = {"out": flash_budget(torch, ref.detach(), torch.cat(outs, 1), f"{name} out", "out")}
        for key, a, b in zip(("dq", "dk", "dv", "ds"), ref_in, mine):
            errs[key] = flash_budget(torch, a.grad, b.grad, f"{name} {key}", key)
        say(f"  {name}: " + ", ".join(f"{key} {e:.2e} ({rel:.2e} of max|ref|)"
                                     for key, (e, rel) in errs.items()))
        worst = max(worst, *(e for e, _ in errs.values()))
    say(f"phase 21c parity ring attend-and-merge over {RING_N} blocks vs flash attention over L: ok, "
        f"max abs err {worst:.3e}")
    return worst


def one_rank_group(torch, np, dev, smi, pair_maps, flash_attn):
    """Phase 21 (d): a one-rank NCCL group driving the scale-out entry points
    on the card: ring_attention_sharded, featurize_sharded(use_kernel=True)
    against the unsharded featurization, pipeline_apply with one stage
    against TrFold.forward, then ``python -m protstruc_tpu_torch train --mesh
    1,1,1 --zero1`` in process at phase 12's configuration against the same
    steps without a mesh: losses, and the AdamW moments the mesh run's
    checkpoint gathered against the plain run's.  K8/K9's counters are reset
    just before the ring and read just after its backward (the lse entry's
    launches), K1's rectangular counter around featurize_sharded.  One rank
    makes no exchange (the ring's n - 1 and the pipeline's S - 1 are 0); the
    collectives that a group of one still runs (all_reduce, all_gather,
    broadcast, all_gather_object) are counted and must have run on NCCL."""
    import torch.distributed as dist

    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.__main__ import main as cli
    from protstruc_tpu_torch.experiments.nccl_ranks import counted as counted_collectives
    from protstruc_tpu_torch.models import trfold
    from protstruc_tpu_torch.ops.ring_attn import ring_attention_sharded
    from protstruc_tpu_torch.parallel.mesh import (featurize_sharded, init_distributed, make_mesh,
                                                   shard_batch)

    rank_dev = init_distributed("cuda", rank=0, world_size=1)
    check(dist.get_backend() == "nccl" and rank_dev == dev, f"group {dist.get_backend()} on {rank_dev}")
    mesh = make_mesh(axis_shapes=(1, 1, 1))
    t0 = time.perf_counter()

    q, k, v, bias, kmask, do = flash_inputs(torch, dev, torch.float32, "ragged", 2, 4, 32, 300, seed=24)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    torch.cuda.synchronize()
    reset_launches(flash_attn)
    out = ring_attention_sharded(*ins, kmask, mesh)
    out.backward(do)
    lse_launches = dict(flash_attn.LAUNCHES)
    ref_in = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    ref = flash_attn.flash_pair_bias_attention(*ref_in, kmask)
    ref.backward(do)
    torch.cuda.synchronize()
    ring_err = max(flash_budget(torch, ref.detach(), out.detach(), "ring one rank out", "out")[0],
                   *(flash_budget(torch, a.grad, b.grad, f"ring one rank {key}", key)[0]
                     for key, a, b in zip(("dq", "dk", "dv", "ds"), ref_in, ins)))

    sb = pt.StructureBatch.from_pdb([str(DATA / p) for p in PDBS], device=dev)
    pair_maps.RECT_LAUNCHES = 0
    with counted_collectives() as feat_calls:
        maps, d, m, frames = featurize_sharded(shard_batch(sb, mesh), mesh, use_kernel=True)
    rect_launches = pair_maps.RECT_LAUNCHES
    g = sb.inter_residue_geometry(use_kernel=True)
    torch.cuda.synchronize()
    n_bad = sum(unequal(g[k], maps[k]) for k in pair_maps.MAP_NAMES)
    check(n_bad == 0, f"featurize_sharded: maps differ from the unsharded K1 at {n_bad} entries")
    for key in ("d_ca_mask", "d_cb_mask", "d_no_mask"):
        check(torch.equal(g[key], maps[key]), f"featurize_sharded: {key}")
    d0, m0 = sb.backbone_dihedrals()
    check(torch.equal(d0.nan_to_num(), d.nan_to_num()) and torch.equal(m0, m), "sharded dihedrals")
    x = sb.xyz
    from protstruc_tpu_torch import geometry as geom
    check(torch.equal(geom.gram_schmidt(x[:, :, 0], x[:, :, 1], x[:, :, 2]).nan_to_num(),
                      frames.nan_to_num()), "sharded frames")

    pp = make_mesh(axis_shapes=(1,), axis_names=("pp",))
    cfg = trfold.TrFoldConfig(node_dim=128, pair_dim=64, n_heads=4, n_blocks=1, pair_update="triangle",
                              fused_tri=True, use_flash_attn=True)
    model = trfold.TrFold(cfg, device=dev)
    params, _, _ = trfold.make_train_state(model, {}, torch.Generator().manual_seed(0), device=dev)
    feats = trfold.featurize_for_model(sb, use_kernel=True)
    with torch.no_grad():
        piped = trfold.pipeline_apply(params, model, feats, pp)
        plain = model(feats)
    torch.cuda.synchronize()
    pipe_err = max(float((piped[k] - plain[k]).abs().max()) for k in plain)
    check(pipe_err <= 1e-5, f"pipeline_apply (one stage) vs TrFold.forward: {pipe_err:.3e}")

    from protstruc_tpu_torch.models.checkpoint import restore_train_state

    losses, moments = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        train_paths = [str(DATA / f) for f in LOO_FILES if f not in (HELD_OUT, DUPLICATE)]
        for mesh_args in ((), ("--mesh", "1,1,1", "--zero1")):
            ck = pathlib.Path(tmp) / ("mesh" if mesh_args else "plain")
            argv = ["train", *train_paths, "--checkpoint-dir", str(ck), "--steps", "3",
                    "--save-every", "3", *FOLD_ARGV, *mesh_args, "--device", str(dev)]
            err = io.StringIO()
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err), \
                    counted_collectives() as calls:
                check(cli(argv) == 0, f"train {' '.join(mesh_args)} returned non-zero")
            if mesh_args:
                check("ZeRO-1" in err.getvalue(), "train --mesh did not log its mesh")
                train_calls = calls
            rows = [json.loads(ln) for ln in (ck / "metrics.jsonl").read_text().splitlines()]
            losses[bool(mesh_args)] = [r["loss"] for r in rows if "loss" in r]
            moments[bool(mesh_args)] = restore_train_state(str(ck))[1]["adamw"]["state"]
    check(len(losses[True]) == 3 and all(map(math.isfinite, losses[True])), f"mesh losses {losses}")
    compare_losses(losses[True], losses[False], 1e-4, "train --mesh 1,1,1 --zero1 vs no mesh")
    # the checkpoint's moments, gathered from their ZeRO-1 owner, against the
    # plain run's: every leaf, within 1e-3 of the leaf's largest entry plus
    # 1e-6 of the model's (the card's run-to-run rounding: a leaf whose
    # gradient is all but 0 holds rounding alone); a leaf gathered wrong
    # is off by its whole size
    check(sorted(moments[True]) == sorted(moments[False]),
          f"zero1 checkpoint holds moments of {len(moments[True])} leaves, not {len(moments[False])}")
    moment_err = 0.0  # the largest error over its tolerance
    for key in ("exp_avg", "exp_avg_sq"):
        top = max(float(st[key].float().abs().max()) for st in moments[False].values())
        for i, st in moments[False].items():
            a, b = moments[True][i][key].float(), st[key].float()
            tol = 1e-3 * float(b.abs().max()) + 1e-6 * top
            e = float((a - b).abs().max())
            check(e <= tol, f"zero1 checkpoint moment {i} {key}: {e:.3e} > {tol:.3e}")
            moment_err = max(moment_err, e / tol)
    nccl = {k: feat_calls[k] + train_calls[k] for k in feat_calls}
    check(all(nccl[k] > 0 for k in ("all_reduce", "all_gather", "broadcast", "all_gather_object")),
          f"phase 21d NCCL collectives {nccl}")
    torch.cuda.synchronize()
    launches = {"rect": rect_launches, "lse_fwd": lse_launches["fwd"], "lse_bwd": lse_launches["bwd"]}
    check(all(n > 0 for n in launches.values()), f"phase 21d launches {launches}")
    dist.destroy_process_group()
    say(f"phase 21d one-rank NCCL group: ok in {time.perf_counter() - t0:.2f} s; ring_attention_sharded "
        f"vs flash max err {ring_err:.3e}; featurize_sharded bitwise equal to the unsharded K1 maps; "
        f"pipeline_apply vs forward {pipe_err:.2e}; train --mesh 1,1,1 --zero1 losses {losses[True]} vs "
        f"no mesh {losses[False]}, checkpoint moments at worst {moment_err:.2e} of their tolerance; "
        f"NCCL collective calls (featurize_sharded + train --mesh) {nccl}; launches: ring (K8/K9 "
        f"through the lse entry) {lse_launches}, featurize_sharded (K1 rect) {rect_launches}")
    return launches, ring_err


def tri_wide_timings(torch, dev, smi, tri_mul, dtype=None):
    """K4-K7 at ``[mfu-peak]``'s pair rows (N = 2*256*256, C = 1024; both
    dtypes: all four on the wide route, where a parent tree, timed against
    this one, may take its streamed passes) beside their plain versions and
    their bounds, each timed by CUDA events over 2 calls after one warm-up,
    in the order plain, kernel, kernel, plain (a parent's float32 streamed
    pass, up to seconds a call, once: its parity run is its warm-up); then
    calls of each under torch.profiler (ten, a float32 streamed pass one),
    its device time split by the kernels of its chain (LayerNorm, gate GEMM,
    and for K5 and K7 back-projection, LayerNorm backward, weight gradients,
    reductions),
    kept only where its kernels add up to within 5 % of the CUDA-event time
    (after phase 21d's NCCL group the profiler has been seen to lose some or
    all of its kernel records).
    Each kernel's outputs at these rows are held to its plain version's
    (tri_kernel_vs_plain).  Returns ({name: (kernel ms, plain ms, bound ms,
    bound_by)}, {name: [(kernel, device ms), ...] or None}, {name: why the
    split is None}, {name: max abs err})."""
    def ms_of(fn, reps=2):
        if reps > 1:
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    dtype = dtype or torch.bfloat16
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    cases = tri_inputs(torch, dev, dtype, PEAK_WIDTH["pair_dim"], B=PEAK_B, L=PEAK_L, seed=5)
    res, split, why, err = {}, {}, {}, {}
    for name in TRI_KERNELS:
        kernel, plain = tri_mul.KERNELS[name]
        try:
            route = tri_route(tri_mul, name, cases[name][0])
        except RuntimeError as e:  # a parent tree's float32 K7 at C = 1024 did not fit its streamed pass
            check(dtype == torch.float32 and not f32_wide_tree(torch, dev, tri_mul), f"{name} {tag}: {e}")
            say(f"phase 21e timing {name} {tag} C={PEAK_WIDTH['pair_dim']} [{smi}]: refused by this "
                f"checkout ({e})")
            continue
        reps = 1 if dtype == torch.float32 and route == "streamed" else 2
        err[name] = tri_kernel_vs_plain(torch, tri_mul, name, cases[name], f"{tag} [mfu-peak] rows")
        torch.cuda.empty_cache()
        got = kernel(*cases[name])
        N, C = cases[name][0].shape
        b = tri_bound(torch, name, cases[name], got if isinstance(got, tuple) else (got,))
        del got
        torch.cuda.empty_cache()
        p1, k1, k2, p2 = (ms_of(lambda f=f: f(*cases[name]), r)
                          for f, r in ((plain, 2), (kernel, reps), (kernel, reps), (plain, 2)))
        res[name] = ((k1 + k2) / 2, (p1 + p2) / 2, *b)
        say(f"phase 21e timing {name} {tag} N={N} C={C} ({route} route) [{smi}]: kernel "
            f"{res[name][0]:.2f} ms, plain {res[name][1]:.2f} ms (plain/kernel/kernel/plain {p1:.2f}, "
            f"{k1:.2f}, {k2:.2f}, {p2:.2f}; kernel {reps} call(s) a turn); bound {b[0]:.4f} ms ({b[1]}"
            f"{', 3xTF32' if dtype == torch.float32 else ''})")
        split[name], tries, calls = None, [], ITERS if reps > 1 else 1
        for _ in range(2):
            _, busy, top = device_profile(torch, lambda: [kernel(*cases[name]) for _ in range(calls)],
                                          top=10)
            tries.append(busy / calls)
            if abs(busy / calls - res[name][0]) <= 0.05 * res[name][0]:
                split[name] = [(kernel_name(k), ms / calls) for k, ms, _ in top]
                break
        if split[name] is None:
            why[name] = (f"torch.profiler's kernels added up to {', '.join(f'{t:.4f}' for t in tries)} ms "
                         f"a call in two sessions, not within 5% of the CUDA-event {res[name][0]:.4f} ms")
        say(f"phase 21e device time {name} {tag} C={C} ({route} route) [{smi}]: torch.profiler "
            + (f"{tries[-1]:.4f} ms a call = " + " + ".join(f"{k} {ms:.4f}" for k, ms in split[name])
               if split[name] else f"no split kept: {why[name]}"))
        torch.cuda.empty_cache()
    del cases
    torch.cuda.empty_cache()
    return res, split, why, err


#: K4-K7's wide-route parity shapes (C, B, L): N = B L^2 rows, each ragged
#: against the 128-row tiles (300, 81 and 2738 rows); C = 144 and 160
#: ragged against the 64-column gate tiles, the 128-column back-projection
#: tiles and (144) the 32-deep k steps
WIDE_CASES = ((256, 3, 10), (256, 2, 37), (1024, 1, 9), (1024, 2, 37), (144, 3, 10), (160, 2, 37))
#: float32 (all four wide): C = 80 and 144 ragged
#: against the gate and back-projection tiles (a float32 stage is 16 deep:
#: no multiple of 16 is ragged against it), 256, and 1024 on ragged rows and
#: on [mfu-peak]'s N = 2*256*256
WIDE_CASES_F32 = ((80, 3, 10), (80, 2, 37), (144, 3, 10), (256, 2, 37), (1024, 1, 9), (1024, 2, 256))


def wide_route(tri_mul, name):
    """The route kernel ``name`` takes at bf16 C > 128: "wide" where the
    tree's counters have that route for it, else "streamed" (the forward
    counters of a tree before K4's and K6's wide route, timed against this
    one, have no "wide")."""
    counters = getattr(tri_mul, "ROUTE_LAUNCHES", {})
    return "wide" if "wide" in counters.get(name, {}) else "streamed"


def wide_parity(torch, dev, tri_mul, f32=False):
    """K4-K7 through the wide route (bf16 C = 144, 160, 256 and 1024, ragged
    N) against their plain versions, every output under tri_budget; the
    route counters must show each call on the kernel's ``wide_route`` (a
    tree before the wide route, timed against this one, has no route
    counters).  With ``f32``, float32 K4-K7 at WIDE_CASES_F32 too, the
    counters showing all four on the wide route.  Returns the largest error
    of each kernel, and with
    ``f32`` also float32's."""
    worst = dict.fromkeys(TRI_KERNELS, 0.0)
    worst32 = dict.fromkeys(TRI_KERNELS, 0.0)
    routes = getattr(tri_mul, "ROUTE_LAUNCHES", None)
    runs = [(torch.bfloat16, case) for case in WIDE_CASES]
    runs += [(torch.float32, case) for case in (WIDE_CASES_F32 if f32 else ())]
    for dtype, (C, B, L) in runs:
        cases = tri_inputs(torch, dev, dtype, C, B=B, L=L)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for name in TRI_KERNELS:
            want = wide_route(tri_mul, name) if tag == "bf16" else expected_tri_route(dtype, C)
            before = dict(routes[name]) if routes else {}
            err = tri_kernel_vs_plain(torch, tri_mul, name, cases[name], f"{tag} C={C} {want} route")
            if routes:
                took = {k: n - before[k] for k, n in routes[name].items() if n > before[k]}
                check(took == {want: 1}, f"{name} {tag} C={C} N={B * L * L}: routes {took}, not {want}")
            acc = worst if tag == "bf16" else worst32
            acc[name] = max(acc[name], err)
        del cases
        torch.cuda.empty_cache()
    return (worst, worst32) if f32 else worst


def mfu_peak(torch, np, dev, smi, tri_mul):
    """Phase 21 (e): ``[mfu-peak]`` at bench.py's full width: K4-K7 through
    the wide route at C = 144, 160, 256 and 1024 on ragged row counts
    against their plain versions first (``wide_parity``), then at the
    step's pair rows, and timed there beside them and their bounds, each
    call split by kernel, then 3 train steps from one init under each remat
    policy, fused_tri off (bench.py's form) and on: losses within 2e-2
    relative of each other, ms/step (the second step; the first warms up,
    the third runs under torch.profiler), peak memory, the ``aten::bmm``
    calls of the profiled step, and each kernel's launches by route (the
    counters reset just before the steps): with fused_tri, each kernel on
    its ``wide_route`` only (all four wide).  Where the checkout's float32
    K5 and K7 take the wide route, float32 K4-K7 at WIDE_CASES_F32 and at
    the step's pair rows too, timed beside their plain versions."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.models.trfold import (TrFold, TrFoldConfig, featurize_for_model,
                                                   make_train_state, train_step)
    from torch.profiler import ProfilerActivity, profile

    f32 = f32_wide_tree(torch, dev, tri_mul)
    tri_err = wide_parity(torch, dev, tri_mul, f32=f32)
    if f32:
        tri_err, err32 = tri_err
        say(f"phase 21e parity K4-K7 f32 (C, N) = "
            f"{', '.join(f'({C}, {B * L * L})' for C, B, L in WIDE_CASES_F32)}, routes "
            f"{ {name: expected_tri_route(torch.float32, 1024) for name in TRI_KERNELS} }: ok, "
            f"max abs err {err32}")
    say(f"phase 21e parity K4-K7 bf16 (C, N) = "
        f"{', '.join(f'({C}, {B * L * L})' for C, B, L in WIDE_CASES)}, routes "
        f"{ {name: wide_route(tri_mul, name) for name in TRI_KERNELS} }: ok, max abs err {tri_err}")
    tri_wide, tri_split, split_why, peak_err = tri_wide_timings(torch, dev, smi, tri_mul)
    say(f"phase 21e parity K4-K7 at [mfu-peak]'s pair rows (N={PEAK_B * PEAK_L ** 2}, C=1024): ok, "
        f"max abs err {peak_err}")
    tri_err = {k: max(e, peak_err[k]) for k, e in tri_err.items()}
    wide32 = None
    if f32:
        res32, split32, why32, peak32 = tri_wide_timings(torch, dev, smi, tri_mul, torch.float32)
        wide32 = (res32, split32, why32, {k: max(e, peak32[k]) for k, e in err32.items()})

    xyz = np.random.RandomState(0).randn(PEAK_B, PEAK_L, 15, 3).astype(np.float32) * 5.0
    feats = featurize_for_model(pt.StructureBatch.from_xyz(xyz, device=dev))
    init, results = None, {}
    for fused in (False, True):
        for policy in POLICIES:
            cfg = TrFoldConfig(dtype=torch.bfloat16, remat_policy=policy, fused_tri=fused, **PEAK_WIDTH)
            model = TrFold(cfg, device=dev)
            params, opt_state, tx = make_train_state(model, feats, torch.Generator().manual_seed(0),
                                                     device=dev)
            if init is None:
                init = {k: v.clone() for k, v in model.state_dict().items()}
            model.load_state_dict(init)
            tri_mul.LAUNCHES.update(dict.fromkeys(tri_mul.LAUNCHES, 0))
            for counts in getattr(tri_mul, "ROUTE_LAUNCHES", {}).values():
                counts.update(dict.fromkeys(counts, 0))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, ms = [], []
            for i in range(PEAK_STEPS):
                if i == PEAK_STEPS - 1:
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        loss = train_step(params, opt_state, feats, model, tx)[2]
                        torch.cuda.synchronize()
                    # the bmm calls that launched a GEMM: under selective
                    # checkpointing an op also shows as the policy mode's outer
                    # call, and a saved one replays from its cache, launching none
                    bmm = sum(1 for e in prof.events() if e.name == "aten::bmm" and e.kernels)
                    calls = sum(1 for e in prof.events() if e.name == "aten::bmm")
                    top = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                                  if e.device_type == torch.autograd.DeviceType.CUDA),
                                 key=lambda k: -k[1])
                    busy = sum(ms for _, ms in top)
                else:
                    t0 = time.perf_counter()
                    loss = train_step(params, opt_state, feats, model, tx)[2]
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
            peak = torch.cuda.max_memory_allocated() / 2**30
            check(all(map(math.isfinite, losses)), f"[mfu-peak] {policy} fused={fused}: losses {losses}")
            check(not fused or all(n > 0 for n in tri_mul.LAUNCHES.values()),
                  f"[mfu-peak] fused: K4-K7 launches {tri_mul.LAUNCHES}")
            routes = {k: {r: n for r, n in v.items() if n}
                      for k, v in getattr(tri_mul, "ROUTE_LAUNCHES", {}).items()}
            if fused and routes:
                for name in TRI_KERNELS:
                    want = wide_route(tri_mul, name)
                    check(list(routes[name]) == [want],
                          f"[mfu-peak] {policy}: {name} launches by route {routes[name]}, not {want} only")
            results[(fused, policy)] = (losses, ms[-1], peak, bmm, routes)
            say(f"  [mfu-peak] fused_tri={fused} remat_policy={policy} [{smi}]: {ms[-1]:.2f} ms/step "
                f"(step 1 {ms[0]:.2f} ms), peak {peak:.2f} GiB, {bmm} bmm GEMMs a step ({calls} "
                f"aten::bmm calls), losses {losses}; K4-K7 launches a step by route "
                f"{ {k: {r: n / PEAK_STEPS for r, n in v.items()} for k, v in routes.items()} }; "
                f"profiled step device busy {busy:.2f} ms: "
                + "; ".join(f"{k[:50]} {t:.2f} ms" for k, t in top[:4]))
            del model, params, opt_state, tx
            torch.cuda.empty_cache()
    base = results[(False, "none")][0]
    for key, (losses, *_) in results.items():
        compare_losses(losses, base, 2e-2, f"[mfu-peak] {key} vs unfused none")
    for fused in (False, True):
        fewer = results[(fused, "none")][3] - results[(fused, "tri_dots")][3]
        check(fewer == 2 * PEAK_WIDTH["n_blocks"],
              f"[mfu-peak] fused={fused}: tri_dots ran {fewer} fewer bmm than none, not "
              f"{2 * PEAK_WIDTH['n_blocks']}")
    say(f"phase 21e [mfu-peak] bf16 B={PEAK_B} L={PEAK_L} {PEAK_WIDTH} [{smi}]: ok; "
        + "; ".join(f"fused_tri={f} {p}: {r[1]:.2f} ms/step, {r[2]:.2f} GiB, {r[3]} bmm"
                    for (f, p), r in results.items()))
    wide_launches = {name: results[(True, "none")][4].get(name, {}).get("wide", 0) for name in TRI_KERNELS}
    return tri_err, tri_wide, (tri_split, split_why), wide_launches, wide32


def moe_card_vs_cpu(torch, np, dev, smi):
    """Phase 21 (f): TrFold with MoE blocks (4 experts) at the ``[mfu-fused]``
    width, f32, B=1, L=128, on the card (K4-K7) against the port on the CPU
    from the same init: loss, aux and every gradient leaf."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.models.trfold import TrFold, TrFoldConfig, featurize_for_model, loss_fn

    xyz = np.random.RandomState(3).randn(1, 128, 15, 3).astype(np.float32) * 5.0
    res, init = [], None
    for d in (dev, torch.device("cpu")):
        feats = featurize_for_model(pt.StructureBatch.from_xyz(xyz, device=d))
        model = TrFold(TrFoldConfig(moe_experts=4, fused_tri=True, **TRAIN_WIDTH), device=d)
        if init is None:
            model.reset_parameters(torch.Generator().manual_seed(0))
            init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        params = dict(model.named_parameters())
        with torch.no_grad():
            aux = float(model(feats)["moe_aux_loss"])
        loss = loss_fn(params, model, feats)
        loss.backward()
        res.append((float(loss.detach()), aux, {k: p.grad.detach().cpu() for k, p in params.items()}))
    (l_g, a_g, g_g), (l_c, a_c, g_c) = res
    check(abs(l_g - l_c) <= 1e-5 * abs(l_c), f"MoE TrFold loss card {l_g!r} vs CPU {l_c!r}")
    check(abs(a_g - a_c) <= 1e-5 * abs(a_c) and a_c > 0, f"MoE aux card {a_g!r} vs CPU {a_c!r}")
    leaf, rel = grad_error(torch, g_c, g_g)
    check(rel <= 1e-4, f"MoE TrFold gradient {leaf}: {rel:.3e} of its largest entry")
    say(f"phase 21f MoE TrFold (4 experts) {TRAIN_WIDTH} f32 B=1 L=128, card vs CPU [{smi}]: ok; loss "
        f"{l_g:.6f} vs {l_c:.6f}, aux {a_g:.6f} vs {a_c:.6f}, worst gradient leaf {leaf} {rel:.2e}")


def lse_timing(torch, dev, flash_attn, ring_attn, smi):
    """The lse entry's forward at the train shape (f32): K8 through it beside
    the plain lse attention, the bound, and the library call that returns an
    lse, ``_scaled_dot_product_efficient_attention(compute_log_sumexp=True)``
    with the additive bias."""
    q, k, v, bias, kmask, _ = flash_inputs(torch, dev, torch.float32, "train", 4, 4, 32, 256)
    with torch.no_grad():
        plain_ms, ms, _ = alternate(lambda: ring_attn.local_attention_lse(q, k, v, bias, kmask, "plain"),
                                    lambda: flash_attn.flash_pair_bias_attention_lse(q, k, v, bias, kmask))
        out, lse = flash_attn.flash_pair_bias_attention_lse(q, k, v, bias, kmask)
        qf, kf, vf = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask_f = bias.masked_fill(~kmask[:, None, None, :], float("-inf")).contiguous()
        lib_out = torch.ops.aten._scaled_dot_product_efficient_attention(
            qf, kf, vf, mask_f, True)
        check(bool(torch.isfinite(lib_out[0]).all()), "library lse attention: non-finite")
        lib_ms = cuda_time_ms(lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            qf, kf, vf, mask_f, True))
    b = bound(nbytes(q, k, v, bias, kmask, out, lse), flash_ops(kmask, 4, 32, 2), torch.float32)
    say(f"phase 21 timing lse entry forward f32 B=4 H=4 dh=32 L=256 [{smi}]: K8 {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, _scaled_dot_product_efficient_attention(compute_log_sumexp) {lib_ms:.4f} ms; "
        f"bound {b[0]:.4f} ms ({b[1]})")
    return ms, plain_ms, lib_ms, b


def scale_out_phase(torch, np, dev, smi):
    """Phase 21: (a)-(f) in order; returns the kernels-line entries' numbers."""
    from protstruc_tpu_torch.ops import flash_attn, pair_maps, ring_attn, tri_mul

    t0 = time.perf_counter()
    rect = rect_parity(torch, np, dev, pair_maps, smi)
    lse_worst = lse_parity(torch, dev, flash_attn, ring_attn)
    ring_worst = ring_merge_parity(torch, dev, flash_attn, ring_attn)
    launches, ring_err = one_rank_group(torch, np, dev, smi, pair_maps, flash_attn)
    lse_ms = lse_timing(torch, dev, flash_attn, ring_attn, smi)
    tri_err, tri_wide, tri_split, wide_launches, wide32 = mfu_peak(torch, np, dev, smi, tri_mul)
    torch.cuda.empty_cache()
    moe_card_vs_cpu(torch, np, dev, smi)
    say(f"phase 21 scale-out path: ok in {time.perf_counter() - t0:.2f} s")
    return {"rect": rect, "launches": launches, "lse_err": max(lse_worst["fwd"], lse_worst["bwd"],
                                                               ring_worst, ring_err),
            "lse_ms": lse_ms, "tri_err_c1024": tri_err, "tri_c1024": tri_wide, "tri_split": tri_split,
            "wide_launches": wide_launches, "wide32": wide32}


# -- phase 22: model parallelism inside FoldModel --------------------------------
#: (L, row-block edges): 37 and 300 residues in 2-4 blocks, as sp ranks hold them
TRI_ROW_BLOCKS = ((37, (0, 20, 37)), (37, (0, 9, 18, 30, 37)), (300, (0, 150, 300)),
                  (300, (0, 64, 150, 233, 300)))
TRI_ROW_WIDTHS = (64, 128)   # fold_loo's pair width (the production FoldModel), [mfu-fused]'s
TRI_PARAMS = ("ln_in", "ln_out", "a_gate", "a_proj", "b_gate", "b_proj", "out_gate", "out_proj")
MP_TIMED = 3                 # timed fwd+bwd calls of each model, after one warm-up


def tri_row_blocks(torch, dev, tri_mul):
    """Phase 22 (a): ``fused_triangle_multiplication`` on row blocks ``(B, Li,
    L, C)`` with the rows' mask and the column mask, as a sharded model's
    rank calls it, against the square launch: outgoing and incoming, f32 and
    bf16, B=2 (structure 0's residue 3 and structure 1's last 5 masked),
    under a row-local contraction (``a * w + b``, so every block hands K6 the
    square's rows).  K4's a and b and K6's output rows must be bitwise the
    square's, and so must the pair's cotangent rows (K5 + K7); the weight
    gradients summed over the blocks within K5's and K7's budgets
    (tri_budget).  The launches counted are the block calls' alone (each
    block's counts read before and after it), and each kernel must launch
    once per block call.  Returns ({dtype: the largest weight-gradient error
    over its max|ref|}, launches)."""
    from protstruc_tpu_torch.ops.tri_mul import fused_triangle_multiplication

    worst, n_blocks = {}, 0
    launches = {k: 0 for k in tri_mul.LAUNCHES}
    for dtype in (torch.float32, torch.bfloat16):
        for C in TRI_ROW_WIDTHS:
            for L, edges in TRI_ROW_BLOCKS:
                gen = torch.Generator(dev).manual_seed(22 * L + C)

                def t(*shape, scale=1.0, shift=0.0):
                    return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

                B = 2
                pair, w, ct = t(B, L, L, C, shift=0.3), t(B, L, L, C), t(B, L, L, C)
                mask = torch.ones((B, L), dtype=torch.bool, device=dev)
                mask[1, L - 5:] = False
                mask[0, 3] = False
                leaves = {n: ((t(C, scale=0.2, shift=1.0), t(C, scale=0.2)) if n.startswith("ln")
                              else (t(C, C, scale=C ** -0.5), t(C, scale=0.1))) for n in TRI_PARAMS}
                for outgoing in (True, False):
                    label = f"{str(dtype)[6:]} C={C} L={L} {'outgoing' if outgoing else 'incoming'}"

                    def run(i0, i1):
                        params = {n: tuple(x.clone().requires_grad_() for x in v)
                                  for n, v in leaves.items()}
                        seen = {}

                        def contract(a, b):
                            seen["a"], seen["b"] = a.detach(), b.detach()
                            return a * w[:, i0:i1] + b

                        x = pair[:, i0:i1].clone().requires_grad_()
                        out = fused_triangle_multiplication(x, mask[:, i0:i1], params, outgoing,
                                                            col_mask=mask, contract=contract)
                        out.backward(ct[:, i0:i1])
                        return out.detach(), x.grad, params, seen

                    sq_out, sq_dx, sq_params, sq_seen = run(0, L)
                    sums = {n: [torch.zeros_like(x, dtype=torch.float32) for x in v]
                            for n, v in leaves.items()}
                    for i0, i1 in zip(edges[:-1], edges[1:]):
                        before = dict(tri_mul.LAUNCHES)
                        out, dx, params, seen = run(i0, i1)
                        for k in launches:
                            launches[k] += tri_mul.LAUNCHES[k] - before[k]
                        for what, got, ref in (("K4 a", seen["a"], sq_seen["a"]),
                                               ("K4 b", seen["b"], sq_seen["b"]),
                                               ("K6 out", out, sq_out), ("K5+K7 dpair", dx, sq_dx)):
                            bad = unequal(ref[:, i0:i1], got)
                            check(bad == 0, f"phase 22a {label} rows {i0}:{i1} {what}: {bad} entries "
                                            "differ from the square launch's")
                        for n in TRI_PARAMS:
                            for acc, x in zip(sums[n], params[n]):
                                acc += x.grad.float()
                        n_blocks += 1
                    for n in TRI_PARAMS:
                        for k, (acc, x) in enumerate(zip(sums[n], sq_params[n])):
                            _, rel = tri_budget(torch, x.grad, acc.to(dtype),
                                                f"phase 22a {label} d{n}[{k}] summed over blocks")
                            key = str(dtype)[6:]
                            worst[key] = max(worst.get(key, 0.0), rel)
    torch.cuda.synchronize()
    check(all(n == n_blocks for n in launches.values()),
          f"phase 22a: the {n_blocks} block calls launched {launches}, not once each per kernel")
    say(f"phase 22a parity K4-K7 on row blocks: ok, {n_blocks} blocks (L 37 and 300 in 2-4 blocks, C "
        f"{TRI_ROW_WIDTHS}, f32 and bf16, outgoing and incoming): K4 a/b, K6 rows and the pair's "
        f"cotangent rows bitwise the square launch's; weight gradients summed over the blocks at worst "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + " of the square's max|ref|; "
        f"launches {launches}")
    return worst, launches


def sharded_fold(torch, np, dev, smi, mesh):
    """Phase 22 (b): FoldModel at fold_loo's width (FOLD_ARGV: f32, D=128,
    P=64, 4 heads, 4 blocks, 6 IPA iterations, recycle 1, triangle, remat,
    fused_tri, flash) sharded over the one-rank NCCL mesh (1, 1, 1) against
    the unsharded model from the same init, on phase 12's batch (BATCH_FILES,
    B=4, crop 256): K3 featurizes the crop, ``shard_feats`` keeps the rank's
    block, then ``fold_loss_fn`` forward and backward on each model.  The
    K3, K4-K7 and K8/K9 counters are reset just before the sharded run and
    read after it; each must have grown.  Then one ``TrainOptimizer`` step
    of each on those gradients, the sharded optimizer's state gathered and
    cut back, the sharded model's whole parameters against the unsharded
    one's; last, each model's featurize + loss + backward timed in turns
    (unsharded, sharded, sharded, unsharded).
    Returns (launches, loss and gradient errors, ms of each model)."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch import train as tr
    from protstruc_tpu_torch.models.checkpoint import load_whole_state, whole_state
    from protstruc_tpu_torch.models.ipa import fold_loss_fn
    from protstruc_tpu_torch.ops import flash_attn, model_features, tri_mul
    from protstruc_tpu_torch.parallel.mesh import shard_feats

    args = dict(zip(FOLD_ARGV[0::2], FOLD_ARGV[1::2]))
    cfg = tr.TrainConfig(batch_size=int(args["--batch-size"]), crop_len=int(args["--crop"]),
                         node_dim=int(args["--node-dim"]), pair_dim=int(args["--pair-dim"]),
                         n_blocks=int(args["--blocks"]), n_recycle=int(args["--recycle"]),
                         pair_update=args["--pair-update"], remat=True, fused_tri=True,
                         use_flash_attn=True, seed=0, mesh_shape=(1, 1, 1))
    plain = tr._build_model(cfg, dev)
    plain.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    sharded = tr._build_model(cfg, dev, mesh)
    load_whole_state(sharded, plain.state_dict())
    check(sharded.shard is not None and sharded.trunk_cfg.ring_mesh is None,
          "phase 22b: the model is not sharded, or rings over sp = 1")
    sb = pt.StructureBatch.from_pdb([str(DATA / f) for f in BATCH_FILES], device=dev)

    def fwd_bwd(model, sharded_feats):
        feats, _, crop = tr._featurize(sb, cfg, model.trunk_cfg,
                                       generator=torch.Generator().manual_seed(CROP_SEED))
        if sharded_feats:
            feats = shard_feats(feats, mesh, axes=("sp",))
        model.zero_grad(set_to_none=True)
        params = dict(model.named_parameters())
        loss = fold_loss_fn(params, model, feats, crop.xyz)
        loss.backward()
        return loss.detach(), {k: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                               for k, p in params.items()}

    torch.cuda.synchronize()
    reset_launches(model_features, tri_mul, flash_attn)
    loss_s, grads_s = fwd_bwd(sharded, True)
    torch.cuda.synchronize()
    launches = {"model_features": model_features.LAUNCHES,
                **{f"tri_mul_{k}": n for k, n in tri_mul.LAUNCHES.items()},
                **{f"flash_attn_{k}": n for k, n in flash_attn.LAUNCHES.items()}}
    check(all(n > 0 for n in launches.values()), f"phase 22b the sharded model launched {launches}")
    loss_p, grads_p = fwd_bwd(plain, False)
    loss_rel = abs(float(loss_s) - float(loss_p)) / abs(float(loss_p))
    check(math.isfinite(float(loss_s)) and loss_rel <= 1e-5,
          f"phase 22b loss sharded {float(loss_s)!r} vs unsharded {float(loss_p)!r}")
    top = max(float(g.abs().max()) for g in grads_p.values())
    grad_worst, grad_leaf = 0.0, None   # the largest error over its budget
    for k, r in grads_p.items():
        e = float((grads_s[k] - r).abs().max())
        ratio = e / (1e-4 * float(r.abs().max()) + 1e-6 * top)
        if ratio > grad_worst:
            grad_worst, grad_leaf = ratio, k
    check(grad_worst <= 1.0, f"phase 22b gradient {grad_leaf}: {grad_worst:.3e} of its budget")

    # one optimizer step of each on those gradients; the sharded state
    # gathered over tp (NCCL, a group of one) and cut back.  Adam's first
    # step is lr * sign(g): entries whose exact gradient is 0 (or all but 0)
    # may move 2 lr apart, the rest agree to rounding
    for model, grads in ((sharded, grads_s), (plain, grads_p)):
        params = dict(model.named_parameters())
        opt = tr.TrainOptimizer(params, cfg, shard=model.shard)
        for k, p in params.items():
            p.grad = grads[k].clone()
        opt.step()
        if model is sharded:
            opt.load_state_dict(opt.state_dict())
    whole, lr = whole_state(sharded), cfg.learning_rate
    step_err = 0.0
    for k, v in plain.state_dict().items():
        noise = zero_grad_entries(torch, k, grads_p[k]) | (grads_p[k].abs() <= 1e-6 * top)
        d = (whole[k] - v).abs()
        if noise.any():
            check(float(d[noise].max()) <= 2 * lr + 1e-6,
                  f"phase 22b optimizer step {k}: a near-zero-gradient entry moved beyond 2 lr")
        if (~noise).any():
            step_err = max(step_err, float(d[~noise].max()))
    check(step_err <= 1e-5, f"phase 22b one optimizer step: sharded params {step_err:.3e} off")
    del grads_s, grads_p

    ms = {}
    for name, model in (("unsharded", plain), ("sharded", sharded), ("sharded again", sharded),
                        ("unsharded again", plain)):
        fwd_bwd(model, model is sharded)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MP_TIMED):
            fwd_bwd(model, model is sharded)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / MP_TIMED

    torch.cuda.synchronize()
    say(f"phase 22b sharded FoldModel D={cfg.node_dim} P={cfg.pair_dim} {cfg.n_blocks} blocks recycle "
        f"{cfg.n_recycle} f32 B={cfg.batch_size} crop {cfg.crop_len} "
        f"on a one-rank NCCL (1, 1, 1) mesh vs unsharded [{smi}]: ok; loss {float(loss_s)!r} vs "
        f"{float(loss_p)!r} ({loss_rel:.2e} relative), worst gradient leaf {grad_leaf} at "
        f"{grad_worst:.2e} of its budget; one optimizer step {step_err:.2e}; featurize + loss + backward "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in ms.items()) + f" (mean of {MP_TIMED}); launches "
        f"{launches}")
    return launches, (loss_rel, grad_worst, step_err), ms


def moe_expert_parallel(torch, dev, smi, mesh):
    """Phase 22 (c): MoEMLP (4 experts, D=128, H=512) with
    ``moe_param_shardings`` over dp on the one-rank NCCL mesh against the
    unsharded layer from the same weights, f32, B=4, L=256 with masked
    tokens: output, aux, and the input, expert and router gradients."""
    from protstruc_tpu_torch.models.moe import MoEMLP, moe_param_shardings
    from protstruc_tpu_torch.parallel.mesh import cut_params

    gen = torch.Generator(dev).manual_seed(22)
    x = torch.randn((4, 256, 128), generator=gen, device=dev)
    mask = torch.rand((4, 256), generator=gen, device=dev) > 0.2
    ct = torch.randn((4, 256, 128), generator=gen, device=dev)
    plain = MoEMLP(128, n_experts=4, hidden_dim=512, device=dev)
    gen5 = torch.Generator().manual_seed(5)
    for mod in plain.modules():   # the router too: MoEMLP's own reset draws the experts
        mod.reset_parameters(gen5)
    ep = MoEMLP(128, n_experts=4, hidden_dim=512, device=dev, mesh=mesh, ep_axis="dp")
    whole = plain.state_dict()
    ep.load_state_dict(cut_params(whole, moe_param_shardings(whole, mesh), mesh))
    res = {}
    for name, m in (("ep", ep), ("plain", plain)):
        xi = x.clone().requires_grad_()
        out, aux = m(xi, mask)
        ((out * ct).sum() + aux).backward()
        res[name] = {"out": out.detach(), "aux": aux.detach(), "dx": xi.grad, "w1": m.w1.grad,
                     "router": m.router.kernel.grad}
    errs = {k: float((res["ep"][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
            for k, v in res["plain"].items()}
    check(all(e <= 1e-5 for e in errs.values()), f"phase 22c MoE EP vs unsharded {errs}")
    say(f"phase 22c MoE (4 experts, D=128, H=512) under moe_param_shardings over dp, one-rank NCCL "
        f"mesh, f32 B=4 L=256 [{smi}]: ok; errors vs unsharded " + ", ".join(
            f"{k} {e:.2e}" for k, e in errs.items()))
    return max(errs.values())


def model_parallel_phase(torch, np, dev, smi):
    """Phase 22: (a)-(c) in order; returns the kernels-line numbers."""
    import torch.distributed as dist

    from protstruc_tpu_torch.ops import tri_mul
    from protstruc_tpu_torch.parallel.mesh import init_distributed, make_mesh

    t0 = time.perf_counter()
    tri_err, row_launches = tri_row_blocks(torch, dev, tri_mul)
    rank_dev = init_distributed("cuda", rank=0, world_size=1)
    check(dist.get_backend() == "nccl" and rank_dev == dev, f"group {dist.get_backend()} on {rank_dev}")
    mesh = make_mesh(axis_shapes=(1, 1, 1))
    launches, errs, ms = sharded_fold(torch, np, dev, smi, mesh)
    torch.cuda.empty_cache()
    moe_err = moe_expert_parallel(torch, dev, smi, mesh)
    dist.destroy_process_group()
    say(f"phase 22 model parallelism: ok in {time.perf_counter() - t0:.2f} s")
    return {"row_launches": row_launches, "tri_row_err": tri_err, "launches": launches,
            "errs": errs, "ms": ms, "moe_err": moe_err}


# -- phase 23: the host layer -------------------------------------------------------
INGEST_REPS, SUSTAINED_REPS = 3, 50          # bench.py:304, 628: passes over the bundled PDBs
DATASET_COPIES, DATASET_BATCH = 10, 4        # bench.py:656: the dataset over files * 10 at batch 4
FETCH_IDS = ["1REX", "6dc4", "1ad0_DC"]      # resolved from tests/data as the cache directory
HIST_BINS, HIST_MAX, CONTACT_CUTOFF = 64, 32.0, 8.0   # distance_histogram's and contact_map's defaults
EXAMPLE_ARGV = ("--steps", "4", "--batch-size", "2")
PARSED_FIELDS = ("atom_xyz", "atom_mask", "chain_idx", "residue_idx", "chain_id_per_res",
                 "residue_number", "insertion", "oneletter")


@contextlib.contextmanager
def cache_only():
    """``fetch_pdb`` resolves from tests/data: the cache directory is set and
    ``urlopen`` refuses, so a miss fails the phase instead of reaching out."""
    import os
    import urllib.request

    def refuse(url, *args, **kwargs):
        raise OSError(f"phase 23 asked for {url}: the entry should come from the cache")

    saved_env, saved_urlopen = os.environ.get("PROTSTRUC_TPU_PDB_CACHE"), urllib.request.urlopen
    os.environ["PROTSTRUC_TPU_PDB_CACHE"] = str(DATA)
    urllib.request.urlopen = refuse
    try:
        yield
    finally:
        urllib.request.urlopen = saved_urlopen
        if saved_env is None:
            os.environ.pop("PROTSTRUC_TPU_PDB_CACHE")
        else:
            os.environ["PROTSTRUC_TPU_PDB_CACHE"] = saved_env


def ingest_lanes(torch, np, dev, smi):
    """Phase 23 (a): the C++ scanner against the NumPy one on every bundled
    PDB, then bench.py's [ingest] and [ingest-sustained] lanes (host time)."""
    from protstruc_tpu_torch.pdbio import native
    from protstruc_tpu_torch.pdbio.dataset import (StructureDataset, clear_parsed_cache,
                                                   parsed_cache_stats)
    from protstruc_tpu_torch.pdbio.parser import parse_pdb

    files = sorted(str(p) for p in DATA.glob("*.pdb"))
    check(native.native_available(), "no C++ scanner: g++ is not on PATH")
    calls = native.CALLS
    fast = [parse_pdb(f, use_native=True) for f in files]
    check(native.CALLS == calls + len(files), f"C++ scans {native.CALLS - calls} for {len(files)} files")
    for f, a in zip(files, fast):
        b = parse_pdb(f, use_native=False)
        check(a.atom_xyz.tobytes() == b.atom_xyz.tobytes(), f"{f}: coordinates differ between scanners")
        for k in PARSED_FIELDS[1:]:
            check(np.array_equal(getattr(a, k), getattr(b, k)), f"{f}: {k} differs between scanners")
        check(a.chain_order == b.chain_order, f"{f}: chain order differs")
    mb = sum(pathlib.Path(f).stat().st_size for f in files) / 1e6
    say(f"phase 23 (a) scanners: the C++ scanner ran {len(files)} times, every field of the "
        f"{len(files)} bundled PDBs equal to the NumPy scanner's, coordinates bitwise")
    out = {}
    for name, use_native in (("numpy", False), ("native", True)):
        for f in files:  # warm the page cache
            parse_pdb(f, use_native=use_native)
        for lane, reps in (("ingest", INGEST_REPS), ("ingest-sustained", SUSTAINED_REPS)):
            t0 = time.perf_counter()
            for _ in range(reps):
                for f in files:
                    parse_pdb(f, use_native=use_native)
            dt = time.perf_counter() - t0
            n = reps * len(files)
            out[f"{lane} {name}"] = n / dt
            say(f"phase 23 (a) [{lane}] {name} [{smi}; host time on the card's machine, warm page "
                f"cache]: {n} parses ({mb * reps:.1f} MB) in {dt * 1e3:.1f} ms -> {n / dt:.1f} "
                f"structures/s, {mb * reps / dt:.1f} MB/s")
    clear_parsed_cache()
    for lane in ("cold", "warm"):
        before = parsed_cache_stats()
        ds = StructureDataset(files * DATASET_COPIES, batch_size=DATASET_BATCH, device=dev)
        shapes, batches, structures = set(), 0, 0
        t0 = time.perf_counter()
        for batch in ds:
            check(batch.xyz.is_cuda, "the dataset did not deliver to the card")
            shapes.add((batch.batch_size, batch.n_residues))
            batches += 1
            structures += batch.batch_size
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        cs = parsed_cache_stats()
        hits, misses = cs["hits"] - before["hits"], cs["misses"] - before["misses"]
        check(structures == len(files) * DATASET_COPIES, f"dataset {lane}: {structures} structures")
        out[f"dataset {lane}"] = structures / dt
        say(f"phase 23 (a) [ingest-sustained] dataset {lane} [{smi}; host time, batches on the card]: "
            f"{batches} batches in {dt:.3f} s ({structures / dt:.1f} structures/s), {len(shapes)} "
            f"(batch, bucket) shapes; parse-cache hit rate {100 * hits / max(hits + misses, 1):.1f}% "
            f"({hits} hits, {misses} misses; {cs['entries']} entries, {cs['bytes'] / 1e6:.1f} MB)")
    return out


def fetch_to_card(torch, pt, pair_maps, dev):
    """Phase 23 (b): from_pdb_id from the cache onto the card, K1 once."""
    with cache_only():
        reset_launches(pair_maps)
        sb = pt.StructureBatch.from_pdb_id(FETCH_IDS)
        g = sb.inter_residue_geometry(use_kernel=True)
        torch.cuda.synchronize()
        launches = pair_maps.LAUNCHES
        ab = pt.AntibodyStructureBatch.from_pdb_id("6dc4", "H", "L")
    check(launches == 1, f"from_pdb_id -> inter_residue_geometry(use_kernel=True) launched K1 {launches} times")
    check(sb.xyz.is_cuda and g["d_cb"].is_cuda and ab.xyz.is_cuda, "from_pdb_id did not land on the card")
    ref_sb = pt.StructureBatch.from_pdb([str(DATA / f"{i}.pdb") for i in FETCH_IDS], device=dev)
    ref = ref_sb.inter_residue_geometry(use_kernel=True)
    for k in ("xyz", "atom_mask", "chain_idx", "residue_idx"):
        a, b = getattr(ref_sb, k), getattr(sb, k)
        check(a.dtype == b.dtype and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes(),
              f"from_pdb_id {k} differs from from_pdb's")
    check(sb.chain_ids == ref_sb.chain_ids and sb.seq == ref_sb.seq, "from_pdb_id metadata differs")
    n = {k: unequal(ref[k], g[k]) if ref[k].is_floating_point() else int((ref[k] != g[k]).sum())
         for k in ref}
    check(sum(n.values()) == 0, f"from_pdb_id maps differ from from_pdb's at {n} entries")
    ab_ref = pt.AntibodyStructureBatch.from_pdb(str(DATA / "6dc4.pdb"), "H", "L", device=dev)
    check(sorted(ab.residue_masks) == sorted(ab_ref.residue_masks), "antibody mask names differ")
    for k, v in ab_ref.residue_masks.items():
        check(ab.residue_masks[k].is_cuda, f"antibody from_pdb_id mask {k} is not on the card")
        check(torch.equal(ab.residue_masks[k], v), f"antibody from_pdb_id mask {k} differs from from_pdb's")
    say(f"phase 23 (b) fetch: StructureBatch.from_pdb_id({FETCH_IDS}) from the cache directory "
        f"{DATA.name}/ on the card (B={sb.batch_size}, L={sb.n_residues}); "
        f"inter_residue_geometry(use_kernel=True): K1 launches {launches}, the {len(g)} outputs bitwise "
        f"equal to from_pdb's; AntibodyStructureBatch.from_pdb_id('6dc4', 'H', 'L'): "
        f"{len(ab.residue_masks)} masks equal to from_pdb's")
    return launches


def histograms_config5(torch, np, pt, pair_maps, dev, smi):
    """Phase 23 (c): distance_histogram and contact_map on config 5's K1 d_cb."""
    from protstruc_tpu_torch.ops import histogram

    _, _, xyz15 = config5_xyz(torch, pt, config5_torsions(np), dev)
    d_cb = pair_maps.pairwise_maps_forward(xyz15, maps=("d_cb",))["d_cb"]
    del xyz15
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    peaks = {}
    for name, fn in (("distance_histogram", lambda: histogram.distance_histogram(d_cb)),
                     ("contact_map", lambda: histogram.contact_map(d_cb, cutoff=CONTACT_CUTOFF))):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
    hist = histogram.distance_histogram(d_cb)
    contact = histogram.contact_map(d_cb, cutoff=CONTACT_CUTOFF)
    valid = (torch.isfinite(d_cb) & (d_cb >= 0) & (d_cb < HIST_MAX)).sum(dim=(1, 2))
    check(hist.dtype == torch.int32 and hist.shape == (CFG5_B, HIST_BINS), f"histogram {hist.dtype} {tuple(hist.shape)}")
    check(torch.equal(hist.sum(1).long(), valid), "a histogram row does not sum to its valid-pair count")
    rows = list(CFG5_PLAIN_ROWS)
    d_rows = d_cb[rows].cpu()
    cpu_hist = histogram.distance_histogram(d_rows)
    dn = d_rows.numpy()
    ok = np.isfinite(dn) & (dn >= 0) & (dn < HIST_MAX)
    bins = (np.where(ok, dn, 0) / np.float32(HIST_MAX) * np.float32(HIST_BINS)).astype(np.int64)
    np_hist = np.stack([np.bincount(bins[r][ok[r]], minlength=HIST_BINS) for r in range(len(rows))])
    check(torch.equal(hist[rows].cpu(), cpu_hist), "card histogram differs from the CPU's on the held rows")
    check(np.array_equal(cpu_hist.numpy(), np_hist), "CPU histogram differs from numpy's bincount")
    check(torch.equal(contact[rows].cpu(), histogram.contact_map(d_rows, cutoff=CONTACT_CUTOFF)),
          "card contact map differs from the CPU's on the held rows")
    del contact
    torch.cuda.empty_cache()
    ms_hist = event_ms(torch, lambda: histogram.distance_histogram(d_cb))
    ms_contact = event_ms(torch, lambda: histogram.contact_map(d_cb, cutoff=CONTACT_CUTOFF))
    pairs = d_cb.numel()
    say(f"phase 23 (c) histograms, config 5 B={CFG5_B} L={CFG5_L} K1 d_cb [{smi}]: distance_histogram "
        f"({HIST_BINS} bins to {HIST_MAX} A) {ms_hist:.4f} ms ({pairs / ms_hist / 1e6:.2f} G pairs/s), peak "
        f"{peaks['distance_histogram']:.3f} GiB over d_cb; contact_map (< {CONTACT_CUTOFF} A) {ms_contact:.4f} ms, "
        f"peak {peaks['contact_map']:.3f} GiB; counts exactly the CPU's (and numpy bincount's) on structures "
        f"{rows[0]}-{rows[7]} and {rows[8]}-{rows[-1]}, every row sums to its valid pairs "
        f"({int(valid.sum())} of {pairs}); contact maps equal on those rows")
    del d_cb, hist, valid
    torch.cuda.empty_cache()
    return {"hist_ms": ms_hist, "contact_ms": ms_contact, "peak_gib": peaks}


def profiling_in_fresh_process():
    """Phase 23 (d), run by a child process on a fresh CUDA context: in this
    process, after phase 22, a ``profile_to`` trace has lost K1's kernel
    record (its ``cudaLaunchKernel`` is there, the kernel activity is not;
    PERF.md §7), which a fresh process does not show."""
    code = ("import torch, chip_smoke, protstruc_tpu_torch as pt; "
            "chip_smoke.profiling_on_card(torch, pt, torch.device('cuda', 0))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    for ln in proc.stdout.splitlines():
        say(ln)
    check(proc.returncode == 0,
          f"phase 23 (d) failed in its process (rc {proc.returncode}):\n{proc.stderr[-4000:]}")


def profiling_on_card(torch, pt, dev):
    """Phase 23 (d): a trace span around K1 in a profile_to trace; Timer.block."""
    from protstruc_tpu_torch.utils.profiling import Timer, profile_to, trace

    sb = pt.StructureBatch.from_pdb([str(DATA / p) for p in PDBS], device=dev)
    sb.inter_residue_geometry(use_kernel=True)  # K1 built and warm
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profile_to(tmp):
            with trace("featurize"):
                sb.inter_residue_geometry(use_kernel=True)
            torch.cuda.synchronize()
        traces = list(pathlib.Path(tmp).glob("*.json"))
        check(len(traces) == 1, f"profile_to wrote {len(traces)} traces")
        names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    k1 = sorted(n for n in names if n and "pair_maps_kernel" in n)
    check("featurize" in names, "the trace span is not in the trace")
    check(bool(k1), "K1's kernel is not in the trace")
    x = torch.randn(2048, 2048, device=dev)
    with Timer("matmuls") as t:
        y = x
        for _ in range(20):
            y = y @ x
        t.block({"y": [y]})
    check(torch.cuda.current_stream().query(), "Timer.block returned before the card's work ended")
    say(f"phase 23 (d) profiling: profile_to's Chrome trace names the span 'featurize' and K1 "
        f"({', '.join(n[:60] for n in k1)}); Timer.block over 20 (2048 x 2048) matmuls {t.elapsed * 1e3:.3f} ms, "
        f"the stream idle after it")
    del x, y


def serialization_on_card(torch, pt, dev):
    """Phase 23 (e): card batches saved and loaded back onto the card, bitwise."""
    from protstruc_tpu_torch.utils.serialization import load_structure_batch, save_structure_batch

    batches = {"plain": pt.StructureBatch.from_pdb([str(DATA / p) for p in PDBS], device=dev).standardize(),
               "antibody": pt.AntibodyStructureBatch.from_pdb([str(DATA / "6dc4.pdb"),
                                                               str(DATA / "15c8_HL.pdb")], "H", "L",
                                                              device=dev)}
    with tempfile.TemporaryDirectory() as tmp:
        for label, b in batches.items():
            path = str(pathlib.Path(tmp) / label)
            save_structure_batch(b, path)
            back = load_structure_batch(path)
            check(type(back) is type(b), f"{label}: loaded a {type(back).__name__}")
            tensors = {k: (getattr(b, k), getattr(back, k)) for k in ("xyz", "atom_mask", "chain_idx",
                                                                      "residue_idx", "mu", "std")}
            tensors.update({f"mask {k}": (v, back.residue_masks[k])
                            for k, v in (getattr(b, "residue_masks", None) or {}).items()})
            for k, (a, c) in tensors.items():
                check((a is None) == (c is None), f"{label}: {k} presence")
                if a is not None:
                    check(c.is_cuda, f"{label}: {k} is not on the card after the round trip")
                    check(a.dtype == c.dtype and a.cpu().numpy().tobytes() == c.cpu().numpy().tobytes(),
                          f"{label}: {k} not bitwise equal after the round trip")
            for k in ("chain_ids", "seq", "standardized", "heavy_chain_id", "light_chain_id",
                      "antigen_chain_ids", "numbering_scheme", "keep_fv_only"):
                check(getattr(b, k, None) == getattr(back, k, None), f"{label}: {k} differs")
    say(f"phase 23 (e) serialization: a standardized batch of {PDBS} and an antibody batch "
        f"(6dc4, 15c8_HL) saved and loaded back onto the card, every tensor bitwise")


def example_on_card(torch, smi):
    """Phase 23 (f): examples/train_trfold over all of tests/data on the card."""
    from protstruc_tpu_torch.examples import train_trfold
    from protstruc_tpu_torch.pdbio import native
    from protstruc_tpu_torch.pdbio.dataset import clear_parsed_cache

    clear_parsed_cache()  # (a) cached every bundled file: the example parses them anew
    calls = native.CALLS
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        written = train_trfold.main(["--data", str(DATA), *EXAMPLE_ARGV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = log.getvalue().strip().splitlines()
    losses = [float(x) for x in re.findall(r"loss=(\S+)", log.getvalue())]
    steps = int(EXAMPLE_ARGV[1])
    check(written == [], f"train_trfold wrote {written}")
    check(lines[0].endswith("backend=cuda"), f"train_trfold did not run on the card: {lines[0]}")
    check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"train_trfold losses {losses}")
    check(native.CALLS > calls, "train_trfold's dataset never ran the C++ scanner")
    say(f"phase 23 (f) example train_trfold {' '.join(EXAMPLE_ARGV)} over {DATA.name}/ on the card "
        f"[{smi}]: {wall:.2f} s ({wall / steps:.3f} s/step with the model's setup and the first "
        f"step's warm-up); C++ scans {native.CALLS - calls}; " + " | ".join(lines))
    return wall / steps


def host_phase(torch, np, dev, smi):
    """Phase 23: (a)-(f) in order; returns the numbers it printed."""
    from protstruc_tpu_torch.ops import pair_maps

    import protstruc_tpu_torch as pt

    t0 = time.perf_counter()
    ingest = ingest_lanes(torch, np, dev, smi)
    fetch_launches = fetch_to_card(torch, pt, pair_maps, dev)
    hist = histograms_config5(torch, np, pt, pair_maps, dev, smi)
    profiling_in_fresh_process()
    serialization_on_card(torch, pt, dev)
    s_per_step = example_on_card(torch, smi)
    say(f"phase 23 host layer: ok in {time.perf_counter() - t0:.2f} s")
    return {"ingest": ingest, "fetch_k1_launches": fetch_launches, **hist, "example_s_per_step": s_per_step}


def fold_step_timing(torch, smi, sb, fold_models_, fold_init, crop_len):
    """Phase 13's FoldModel train step (featurization included), kernel path
    against plain path in turns (ms/step, peak memory, each step from the
    initial parameters), then one step of each under torch.profiler (device
    busy, the top kernels, and every K4-K7 kernel of the kernel path's
    step)."""
    from protstruc_tpu_torch.train import TrainOptimizer
    from protstruc_tpu_torch.train import train_step as fold_train_step

    fold_step_ms, fold_peak, fold_step_losses = {}, {}, {True: [], False: []}

    def fold_stepper(kernel):
        model, c = fold_models_[kernel]
        params = dict(model.named_parameters())
        opt = TrainOptimizer(params, c)
        opt_init = copy.deepcopy(opt.state_dict())
        state = model.state_dict()
        leaves = [(state[k], v) for k, v in fold_init.items()]

        def step():
            with torch.no_grad():
                for leaf_, v in leaves:
                    leaf_.copy_(v)
            opt.load_state_dict(opt_init)
            feats, xyz_true = fold_featurize(torch, sb, model, c, kernel)
            fold_step_losses[kernel].append(fold_train_step(model, params, opt, feats, None, xyz_true))
        return step

    steppers = {kernel: fold_stepper(kernel) for kernel in (True, False)}
    for kernel, step in steppers.items():
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        fold_peak[kernel] = torch.cuda.max_memory_allocated() / 2**30
    fold_step_ms[False], fold_step_ms[True], rounds = alternate(steppers[False], steppers[True])
    for kernel, step in steppers.items():
        wall, busy, every = device_profile(torch, step, top=None)
        say(f"phase 13 profile FoldModel train step, {'kernel' if kernel else 'plain'} path, one step "
            f"under torch.profiler: device busy {busy:.2f} of {wall:.2f} ms wall "
            f"(idle {100 * (1 - busy / wall):.1f}%); top kernels "
            + "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for name, ms, n in every[:6]))
        if kernel:  # K4-K7's kernels in that step, however far down the list
            tri = [(kernel_name(name), ms, n) for name, ms, n in every
                   if re.search(r"namespace\)::((prologue|epilogue)_\w+|wgrad|reduce)_kernel<", name)]
            say("phase 13 device time K4-K7 in one kernel-path step: "
                + "; ".join(f"{name} {ms:.2f} ms x{n}" for name, ms, n in tri))
    for kernel, losses in fold_step_losses.items():
        losses = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(losses).all()), f"timed FoldModel steps kernel={kernel}: losses {losses}")
        fold_step_losses[kernel] = (float(losses.min()), float(losses.max()), len(losses))
    say(f"phase 13 timing FoldModel train step f32 B=4 crop {crop_len} [{smi}]: kernel path "
        f"{fold_step_ms[True]:.4f} ms/step (peak {fold_peak[True]:.2f} GiB), plain path "
        f"{fold_step_ms[False]:.4f} ms/step (peak {fold_peak[False]:.2f} GiB) "
        f"(plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)}); each step from the "
        f"initial parameters, losses (min, max, steps) kernel {fold_step_losses[True]}, "
        f"plain {fold_step_losses[False]}")


# -- phase 24: every width the JAX package takes ------------------------------------
#: K4-K7 at pair widths that are not a multiple of 16 (the wrappers stage them
#: to round_up(C, 16), zero past C): (dtype, C, B, L), N = B L^2 rows ragged
#: against the 16-row and 128-row tiles; C = 7, 8, 24 and 40 on the resident
#: route in both dtypes (40: f32 at 48, still resident), bf16 C = 200 and
#: f32 C = 72 and 100 on the wide route
WIDTH_TRI = tuple((dt, C, 2, 37) for dt in ("float32", "bfloat16") for C in (7, 8, 24, 40)) + (
    ("bfloat16", 200, 2, 37), ("float32", 72, 2, 37), ("float32", 100, 3, 10))
WIDTH_TRI_OFF = 24            # the case run again on operands off a 16-byte boundary
#: K8/K9 head dims other than 16, 32, 64 and 128: up to 256 the whole route
#: (256 its own instantiation, the others staged to the next built width:
#: 16, 32, 64, 128, 256), above it the chunked route (512 and 2048 at their own
#: width, the others staged to the next multiple of 128)
WIDTH_DH = (8, 12, 24, 48, 96, 256, 257, 320, 512, 1000, 2048)
WIDTH_LSE_DH = (24, 256, 512)  # the lse entry (the ring's local step) held at these
WIDTH_FLASH = ((2, 4, 37), (2, 2, 300))   # (B, H, L): L ragged against 64; batch row 1 fully masked
#: the small ragged TrFold step: node 96 over 4 heads (dh 24), pair 40
WIDTH_TRFOLD = dict(node_dim=96, pair_dim=40, n_heads=4, n_blocks=2, pair_update="triangle",
                    remat=True)
WIDTH_TRFOLD_B, WIDTH_TRFOLD_L, WIDTH_STEPS = 2, 96, 3
WIDTH_TIMED_C = 24            # K4-K7 timed at [mfu-fused]'s rows (N = 4*512^2) at this width


def width_tri_parity(torch, dev, tri_mul):
    """Phase 24 (a): K4-K7 at every WIDTH_TRI case and at C = WIDTH_TRI_OFF
    on operands off a 16-byte boundary, each against its plain version
    (every output under tri_budget); each call must add one launch on the
    route make_plan reads at round_up(C, 16), and nothing else (no plain
    call).  Then the whole op (forward and backward, outgoing and incoming)
    at C = 24 against the plain path on the CPU.  Returns the largest error
    of each kernel."""
    worst = dict.fromkeys(TRI_KERNELS, 0.0)
    runs = [(getattr(torch, dt), C, B, L, False) for dt, C, B, L in WIDTH_TRI]
    runs += [(getattr(torch, dt), WIDTH_TRI_OFF, 2, 37, True) for dt in ("float32", "bfloat16")]
    for dtype, C, B, L, off in runs:
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        want = expected_tri_route(dtype, tri_mul.padded_width(C))
        cases = tri_inputs(torch, dev, dtype, C, B=B, L=L, seed=C)
        for name in TRI_KERNELS:
            args = cases[name]
            if off:
                args = [off_alignment(torch, t) for t in args]
                check(all(t.data_ptr() % 16 for t in args), "the offset copies are aligned")
            check(tri_mul.route(name, args[0]) == want, f"{name} {tag} C={C}: route {tri_mul.route(name, args[0])}")
            before = ({k: dict(v) for k, v in tri_mul.ROUTE_LAUNCHES.items()}, dict(tri_mul.LAUNCHES))
            err = tri_kernel_vs_plain(torch, tri_mul, name, args,
                                      f"{tag} C={C} {want} route{' off alignment' if off else ''}")
            took = {(k, r): n - before[0][k][r] for k, v in tri_mul.ROUTE_LAUNCHES.items()
                    for r, n in v.items() if n > before[0][k][r]}
            check(took == {(name, want): 1} and tri_mul.LAUNCHES[name] == before[1][name] + 1,
                  f"{name} {tag} C={C} N={B * L * L}: launches {took}, not one on {want}")
            worst[name] = max(worst[name], err)
        del cases
    for dtype in (torch.float32, torch.bfloat16):
        C, B, L = 24, 2, 37
        cases = tri_inputs(torch, dev, dtype, C, B=B, L=L, seed=3)
        w = cases["epilogue_fwd"][2:]
        params = {"ln_in": w[0:2], "out_gate": w[2:4], "ln_out": w[4:6], "out_proj": w[6:8],
                  "a_gate": cases["prologue_fwd"][4:6], "a_proj": cases["prologue_fwd"][6:8],
                  "b_gate": cases["prologue_fwd"][8:10], "b_proj": cases["prologue_fwd"][10:12]}
        pair = cases["prologue_fwd"][0].reshape(B, L, L, C)
        ct = cases["epilogue_bwd"][-1].reshape(pair.shape)
        for outgoing in (True, False):
            outs = []
            for d in (dev, torch.device("cpu")):
                leaves = [pair.detach().to(d).requires_grad_()] + [
                    v.detach().to(d).requires_grad_() for pair_ in params.values() for v in pair_]
                it = iter(leaves[1:])
                prm = {k: (next(it), next(it)) for k in params}
                y = tri_mul.fused_triangle_multiplication(leaves[0], cases["mask"].to(d), prm, outgoing)
                grads = torch.autograd.grad(y, leaves, ct.to(d))
                outs.append([y.detach().cpu()] + [g.cpu() for g in grads])
            torch.cuda.synchronize()
            errs = [tri_budget(torch, r, o, f"op C={C} outgoing={outgoing} {dtype} #{i}")[0]
                    for i, (o, r) in enumerate(zip(*outs))]
            say(f"  fused_triangle_multiplication {str(dtype)[6:]} C={C} L={L} outgoing={outgoing}: "
                f"out {errs[0]:.2e}, grads max {max(errs[1:]):.2e} over {len(errs) - 1} leaves")
        del cases
    torch.cuda.empty_cache()
    return worst


def flash_route_launches(fa):
    """{(part, route): K8/K9 launches} so far, the routes that launched."""
    return {(part, r): n for part, c in fa.ROUTE_LAUNCHES.items() for r, n in c.items() if n}


def width_flash_parity(torch, dev, fa, ring_attn):
    """Phase 24 (b): K8/K9 at every WIDTH_DH, f32 and bf16, on WIDTH_FLASH
    (ragged L, batch row 1 fully masked) against their plain versions
    (flash_vs_plain: out, lse, ds, dk, dv, dq); each pair of calls must add
    one K8 and one K9 launch, on the route ``head_dim_route`` names (above
    256 the chunked one).  At WIDTH_LSE_DH the lse entry (the ring's local
    step) against the plain local attention too.  Returns ({fwd, bwd: the
    largest error}, the same at dh 256 alone, the same on the chunked route
    alone)."""
    worst, worst256, worst_chunked = ({"fwd": 0.0, "bwd": 0.0} for _ in range(3))
    for dtype in (torch.float32, torch.bfloat16):
        for dh in WIDTH_DH:
            route = fa.head_dim_route(dh)
            for B, H, L in WIDTH_FLASH:
                args = flash_inputs(torch, dev, dtype, "ragged", B, H, dh, L, seed=dh + L)
                before, before_routes = dict(fa.LAUNCHES), flash_route_launches(fa)
                errs = flash_vs_plain(torch, fa, args, f"{str(dtype)[6:]} B={B} H={H} dh={dh} "
                                                       f"({route} at {fa.kernel_head_dim(dh)}) L={L}")
                check({k: n - before[k] for k, n in fa.LAUNCHES.items()} == {"fwd": 1, "bwd": 1},
                      f"flash dh={dh}: launches {fa.LAUNCHES} from {before}")
                took = {k: n - before_routes.get(k, 0) for k, n in flash_route_launches(fa).items()
                        if n > before_routes.get(k, 0)}
                check(took == {("fwd", route): 1, ("bwd", route): 1}, f"flash dh={dh}: launches by route {took}")
                for key in worst:
                    worst[key] = max(worst[key], errs[key])
                    if dh == 256:
                        worst256[key] = max(worst256[key], errs[key])
                    if route == "chunked":
                        worst_chunked[key] = max(worst_chunked[key], errs[key])
            if dh in WIDTH_LSE_DH:
                q, k, v, bias, kmask, _ = flash_inputs(torch, dev, dtype, "ragged", 2, 4, dh, 37, seed=dh)
                with torch.no_grad():
                    got = fa.flash_pair_bias_attention_lse(q, k, v, bias, kmask)
                    ref = ring_attn.local_attention_lse(q, k, v, bias, kmask, "plain")
                live = kmask.any(-1)
                err = flash_budget(torch, ref[0], got[0], f"lse entry dh={dh} out", "out")[0]
                lse_err = flash_budget(torch, ref[1][live], got[1][live], f"lse entry dh={dh} lse", "lse")[0]
                check(bool(torch.isinf(got[1][~live]).all()), f"lse entry dh={dh}: a row with no key")
                worst["fwd"] = max(worst["fwd"], err, lse_err)
                if dh == 256:
                    worst256["fwd"] = max(worst256["fwd"], err, lse_err)
                if route == "chunked":
                    worst_chunked["fwd"] = max(worst_chunked["fwd"], err, lse_err)
                say(f"  flash lse entry {str(dtype)[6:]} dh={dh}: out {err:.2e}, lse {lse_err:.2e}")
            torch.cuda.empty_cache()
    return worst, worst256, worst_chunked


def counted_steps(torch, feats, entry, n, tri_mul, fa):
    """``n`` train steps with every K4-K7 and K8/K9 counter reset just before
    and read just after: (losses, ms of each step (host clock to a
    synchronize), (peak GiB, GiB held just before the steps), K4-K7 launches
    by route, K8/K9 launches, K8/K9 launches by route)."""
    from protstruc_tpu_torch.models.trfold import train_step

    model, params, opt_state, tx = entry
    reset_launches(tri_mul, fa)
    for counts in (*tri_mul.ROUTE_LAUNCHES.values(), *fa.ROUTE_LAUNCHES.values()):
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        params, opt_state, loss = train_step(params, opt_state, feats, model, tx)
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    routes = {k: {r: c for r, c in v.items() if c} for k, v in tri_mul.ROUTE_LAUNCHES.items()}
    return (losses, ms, (torch.cuda.max_memory_allocated() / 2**30, base), routes, dict(fa.LAUNCHES),
            flash_route_launches(fa))


def width_trfold_step(torch, np, dev, smi, tri_mul, fa):
    """Phase 24 (c): TrFold at WIDTH_TRFOLD (dh 24, pair 40) with fused_tri
    and flash against the unfused einsum step from one init, f32 and bf16,
    WIDTH_STEPS steps each: losses within 1e-5 (f32) and 2e-2 (bf16)
    relative; the kernel path's counters (reset just before its steps, read
    just after) must show K4-K7 on the resident route only and K8/K9
    launched.  Returns (K4-K7 launches, K8/K9 launches) of the f32 run."""
    xyz = np.random.RandomState(6).randn(WIDTH_TRFOLD_B, WIDTH_TRFOLD_L, 15, 3).astype(np.float32) * 5.0
    launches = None
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        feats, models, _ = seeded_models(torch, dev, dict(WIDTH_TRFOLD, dtype=dtype), xyz, {
            "kernels": dict(fused_tri=True, use_flash_attn=True),
            "einsum": dict(fused_tri=False, use_flash_attn=False)})
        losses, ms, _, routes, flash_n, _ = counted_steps(torch, feats, models["kernels"], WIDTH_STEPS, tri_mul, fa)
        tri_n = dict(tri_mul.LAUNCHES)
        check(all(math.isfinite(x) for x in losses), f"ragged TrFold {dtype}: losses {losses}")
        for name in TRI_KERNELS:
            check(list(routes[name]) == ["resident"], f"ragged TrFold {dtype}: {name} routes {routes[name]}")
        check(all(n > 0 for n in flash_n.values()), f"ragged TrFold {dtype}: K8/K9 launches {flash_n}")
        plain, _, _, _, plain_flash, _ = counted_steps(torch, feats, models["einsum"], WIDTH_STEPS, tri_mul, fa)
        check(sum(tri_mul.LAUNCHES.values()) == 0 and sum(plain_flash.values()) == 0,
              "the einsum step launched a kernel")
        compare_losses(losses, plain, rtol, f"ragged TrFold {dtype}")
        say(f"phase 24 (c) TrFold {WIDTH_TRFOLD} {str(dtype)[6:]} B={WIDTH_TRFOLD_B} L={WIDTH_TRFOLD_L} "
            f"(dh {WIDTH_TRFOLD['node_dim'] // WIDTH_TRFOLD['n_heads']}) [{smi}]: fused_tri + flash losses "
            f"{losses} vs einsum {plain}; launches in {WIDTH_STEPS} steps K4-K7 {routes}, K8/K9 {flash_n}")
        if launches is None:
            launches = (tri_n, flash_n)
        del feats, models
        torch.cuda.empty_cache()
    return launches


#: [mfu-peak] over 4 heads (dh 512): the chunked route in the model
PEAK_CHUNKED_HEADS = 4


def peak_flash_step(torch, np, dev, smi, tri_mul, fa, heads):
    """Phase 24 (d): ``[mfu-peak]`` (PEAK_WIDTH: node 2048) over ``heads``
    heads (8: dh 256 on the whole route; 4: dh 512 on the chunked route)
    with fused_tri and flash against fused_tri on einsum attention, from one
    init, bf16, B=PEAK_B, L=PEAK_L, in four runs of PEAK_STEPS steps in the
    order flash, einsum, einsum, flash (each model goes on from its own
    state; the counters reset just before a run, read just after): the
    first runs' losses within 2e-2 relative, ms/step over the steps of both
    runs but the first (both models are held throughout, and from the
    second run on both optimizer states), the peak and the peak above what
    was held just before a run (the larger of the two runs), K8/K9 launches
    a step: 2 K8 (the forward and its recompute under remat) and 1 K9 a
    block, all on the dh's route, the same in both flash runs.  Returns
    {label: (ms/step, peak GiB, K8/K9 launches a step, peak GiB above the
    memory held before the steps)}."""
    width = dict(PEAK_WIDTH, n_heads=heads)
    dh = width["node_dim"] // heads
    route = fa.head_dim_route(dh)
    per_step = {"fwd": 2 * width["n_blocks"], "bwd": width["n_blocks"]}
    tag = f"[mfu-peak] over {heads} heads (dh {dh}, {route} route)"
    xyz = np.random.RandomState(0).randn(PEAK_B, PEAK_L, 15, 3).astype(np.float32) * 5.0
    feats, models, _ = seeded_models(torch, dev, dict(width, dtype=torch.bfloat16), xyz, {
        "flash": dict(fused_tri=True, use_flash_attn=True),
        "einsum": dict(fused_tri=True, use_flash_attn=False)})
    runs = {"flash": [], "einsum": []}
    for label in ("flash", "einsum", "einsum", "flash"):
        losses, ms, (peak, base), routes, flash_n, flash_routes = counted_steps(
            torch, feats, models[label], PEAK_STEPS, tri_mul, fa)
        check(all(math.isfinite(x) for x in losses), f"{tag} {label}: losses {losses}")
        for name in TRI_KERNELS:
            check(list(routes[name]) == ["wide"], f"{tag} {label}: {name} routes {routes[name]}")
        if label == "flash":
            check(flash_n == {k: n * PEAK_STEPS for k, n in per_step.items()}
                  and flash_routes == {(k, route): n for k, n in flash_n.items()},
                  f"{tag} flash: K8/K9 launches {flash_n}, by route {flash_routes}")
        else:
            check(sum(flash_n.values()) == 0, f"{tag} einsum: K8/K9 launches {flash_n}")
        runs[label].append((losses, ms, peak, base, flash_n))
        say(f"phase 24 (d) {tag} fused_tri {label} attention bf16 B={PEAK_B} L={PEAK_L} {width} "
            f"run {len(runs[label])} [{smi}]: steps {', '.join(f'{m:.2f}' for m in ms)} ms, peak {peak:.2f} "
            f"GiB, {peak - base:.2f} above the {base:.2f} held before the steps, losses {losses}, "
            f"K8/K9 launches {flash_n} ({route} route)")
        torch.cuda.empty_cache()
    compare_losses(runs["flash"][0][0], runs["einsum"][0][0], 2e-2, f"{tag} flash vs einsum")
    check(runs["flash"][0][4] == runs["flash"][1][4], f"{tag} flash launches {runs['flash']}")
    res = {}
    for label, (first, second) in runs.items():
        warm = first[1][1:] + second[1]
        res[label] = (sum(warm) / len(warm), max(first[2], second[2]),
                      {k: n / PEAK_STEPS for k, n in first[4].items()},
                      max(first[2] - first[3], second[2] - second[3]))
        say(f"phase 24 (d) {tag} fused_tri {label} attention [{smi}]: {res[label][0]:.2f} ms/step over "
            f"{len(warm)} steps, peak {res[label][1]:.2f} GiB ({res[label][3]:.2f} above the start of a run), "
            f"K8/K9 launches a step {res[label][2]}")
    del feats, models
    torch.cuda.empty_cache()
    return res


def sdpa_backend(names):
    """The SDPA backend that ran, read from its kernels' names; unknown
    where the profiler recorded none."""
    if not names:
        return "unknown (no profiler record)"
    text = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                         ("efficient", "efficient")):
        if key in text:
            return backend
    return f"math ({'; '.join(kernel_name(n)[:40] for n in names)})"


#: K8/K9 on the chunked route timed at [mfu-peak]'s node attention shape
#: (bf16, B=PEAK_B, L=PEAK_L): (heads, dh).  dh 512 and 2048 are the model's
#: node 2048 over 4 and 1 heads; 3072 and 4096 (one head of a node that wide)
#: find where the recomputed q k^T (dh/128 times) lets the plain version pass
CHUNKED_TIMED = ((4, 512), (1, 2048), (1, 3072), (1, 4096))


def node_attention_timing(torch, dev, fa, smi, heads, phase, dh=None):
    """K8/K9 at ``[mfu-peak]``'s node attention over ``heads`` heads (bf16,
    its bias in the model's permuted layout; ``dh`` defaults to the model's
    node 2048 over ``heads``): held to their plain versions on the timed
    inputs, then timed beside their plain versions, bounds and SDPA with the
    float mask (flash_timings).  Returns (errors, flash_ms, times, SDPA's
    backend {forward, backward})."""
    B, L = PEAK_B, PEAK_L
    dh = dh or PEAK_WIDTH["node_dim"] // heads
    errs = flash_vs_plain(torch, fa, flash_inputs(torch, dev, torch.bfloat16, "train", B, heads, dh, L),
                          f"[mfu-peak] node attention bf16 B={B} H={heads} dh={dh} L={L}")
    flash_ms, times = flash_timings(torch, dev, fa, "train", torch.bfloat16, B, heads, dh, L)
    backend = {k: sdpa_backend(times[f"SDPA {k}"][2]) for k in ("forward", "backward")}
    for part, (k_ms, p_ms, lib_ms, b_ms, b_by) in flash_ms.items():
        say(f"{phase} timing K{8 if part == 'fwd' else 9} ({part}) [mfu-peak] node attention bf16 B={B} "
            f"H={heads} dh={dh} L={L} [{smi}]: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA "
            f"{'forward' if part == 'fwd' else 'backward'} {lib_ms:.4f} ms "
            f"({backend['forward' if part == 'fwd' else 'backward']}); bound {b_ms:.4f} ms ({b_by})")
    for name, (ev, dv, names) in times.items():
        say(f"{phase} device time {name} dh={dh} [{smi}]: CUDA events {ev:.4f} ms, torch.profiler "
            f"{fmt_ms(dv)} a call ({'; '.join(kernel_name(n)[:70] for n in names)})")
    torch.cuda.empty_cache()
    return errs, flash_ms, times, backend


def width_phase(torch, np, dev, smi):
    """Phase 24: (a) K4-K7 and (b) K8/K9 at the widths the JAX package takes
    beyond the multiples of 16 and the four head dims of the earlier
    phases, against their plain versions; (c) the small ragged
    TrFold step; (d) ``[mfu-peak]`` with flash over 8 heads (dh 256) and 4
    (dh 512, the chunked route); (e) timings: K4-K7 at bf16 C = 24 on
    ``[mfu-fused]``'s rows and K8/K9 on ``[mfu-peak]``'s node attention at
    dh 256, 512 and 2048, and its shape at dh 3072 and 4096 (one head; the
    bias in the model's permuted layout), beside their plain versions,
    bounds and (K8/K9) SDPA with the float mask, K8/K9 held to their plain
    versions on those inputs first; the timed dh at which a plain version
    was faster.  Returns the kernels-line numbers."""
    from protstruc_tpu_torch.ops import flash_attn as fa
    from protstruc_tpu_torch.ops import ring_attn, tri_mul

    t0 = time.perf_counter()
    tri_err = width_tri_parity(torch, dev, tri_mul)
    say(f"phase 24 (a) parity K4-K7 at (dtype, C) = "
        f"{', '.join(f'({dt[:4]}, {C})' for dt, C, _, _ in WIDTH_TRI)} and C={WIDTH_TRI_OFF} off "
        f"alignment: ok, every call one launch on its route, max abs err {tri_err}")
    flash_err, flash_err256, flash_err_chunked = width_flash_parity(torch, dev, fa, ring_attn)
    say(f"phase 24 (b) parity K8/K9 at dh = {', '.join(map(str, WIDTH_DH))} (run at "
        f"{', '.join(f'{fa.kernel_head_dim(d)} {fa.head_dim_route(d)}' for d in WIDTH_DH)}), (B, H, L) = "
        f"{WIDTH_FLASH}: ok, every pair of calls one K8 and one K9 launch on its route, max abs err "
        f"{flash_err}, on the chunked route {flash_err_chunked}")
    tri_launches, flash_launches = width_trfold_step(torch, np, dev, smi, tri_mul, fa)
    peak = peak_flash_step(torch, np, dev, smi, tri_mul, fa, PEAK_WIDTH["n_heads"])
    peak_chunked = peak_flash_step(torch, np, dev, smi, tri_mul, fa, PEAK_CHUNKED_HEADS)
    tri_worst = dict(tri_err)
    tri_ms, tri_split = tri_timings(torch, dev, smi, tri_worst, torch.bfloat16, C=WIDTH_TIMED_C,
                                    phase="phase 24 (e)")
    errs, flash_ms, times, backend256 = node_attention_timing(torch, dev, fa, smi, PEAK_WIDTH["n_heads"],
                                                              "phase 24 (e)")
    flash_err256 = {k: max(v, errs[k]) for k, v in flash_err256.items()}
    chunked = {}
    for heads, dh in CHUNKED_TIMED:
        c_errs, c_ms, c_times, backend = node_attention_timing(torch, dev, fa, smi, heads, "phase 24 (e)", dh)
        flash_err_chunked = {k: max(v, c_errs[k]) for k, v in flash_err_chunked.items()}
        chunked[dh] = {"heads": heads, "flash_ms": c_ms, "sdpa_backend": backend,
                       "device_ms": {name: {"events": ev, "profiler": dv} for name, (ev, dv, _) in c_times.items()}}
    say(f"phase 24 (e) parity K8/K9 at [mfu-peak]'s node attention: ok; max abs err at dh 256 over phase 24 "
        f"{flash_err256}, on the chunked route {flash_err_chunked}")
    for part in ("fwd", "bwd"):
        say(f"phase 24 (e) K{8 if part == 'fwd' else 9} on the chunked route against its plain version "
            f"[{smi}]: " + ", ".join(f"dh {dh} {c['flash_ms'][part][0]:.4f} / {c['flash_ms'][part][1]:.4f} ms"
                                     for dh, c in chunked.items())
            + f"; the plain version faster at dh {plain_faster(chunked, part) or 'none of these'}")
    say(f"phase 24 every width: ok in {time.perf_counter() - t0:.2f} s")
    return {"tri_err": tri_worst, "flash_err": flash_err256, "tri_launches": tri_launches,
            "flash_launches": flash_launches, "peak": peak, "tri_ms": tri_ms, "tri_split": tri_split,
            "flash_ms": flash_ms, "sdpa_kernels": {k: times[f"SDPA {k}"][2] for k in ("forward", "backward")},
            "sdpa_backend": backend256,
            "peak_chunked": peak_chunked, "chunked": chunked, "flash_err_chunked": flash_err_chunked}


def plain_faster(chunked, part):
    """The timed dh at which K8 (``part`` fwd) or K9 (bwd) on the chunked
    route took longer than its plain version."""
    return [dh for dh, c in chunked.items() if c["flash_ms"][part][0] > c["flash_ms"][part][1]]


def width_entries(entry, widths):
    """Phase 24's entries of the kernels line from ``width_phase``'s
    numbers: K4-K7 at a ragged width (launches in the ragged TrFold step's
    f32 run, times at bf16 C = 24 on ``[mfu-fused]``'s rows), K8/K9 at
    dh 256 (launches in the ``[mfu-peak]`` flash steps over 8 heads, times
    at its node attention) and on the chunked route (launches in the
    ``[mfu-peak]`` flash steps over 4 heads, times at its node attention,
    dh 512); ``entry`` builds one entry as main's does."""
    kernels = []
    for name in TRI_KERNELS:
        kernels.append(dict(entry(f"tri_mul_{name}_ragged_c", "tri_mul.cu", TRI_REPLACES[name],
                                  widths["tri_launches"][name], widths["tri_err"][name],
                                  *widths["tri_ms"][name], None),
                            mode="K4-K7 at C not a multiple of 16, staged to round_up(C, 16): parity at "
                                 "C=7, 8, 24, 40 (resident), bf16 200 and f32 72, 100 (wide), and off "
                                 "alignment; launches in the ragged TrFold step (pair 40, f32, 3 steps)",
                            shape=f"N=4*512*512 C={WIDTH_TIMED_C} bf16, [mfu-fused]'s pair rows",
                            device_ms_by_kernel=dict(widths["tri_split"][name])))
    peak_flash, peak_chunked = widths["peak"], widths["peak_chunked"]
    timed_heads, timed_dh = CHUNKED_TIMED[0]
    for part, replaces in (("fwd", "protstruc_tpu/ops/flash_attn.py:79"),
                           ("bwd", "protstruc_tpu/ops/flash_attn.py:184")):
        k_ms, p_ms, lib_ms, b_ms, b_by = widths["flash_ms"][part]
        kernels.append(dict(entry(f"flash_attn_{part}_dh256", "flash_attn.cu", replaces,
                                  round(peak_flash["flash"][2][part] * PEAK_STEPS), widths["flash_err"][part],
                                  k_ms, p_ms, b_ms, b_by, lib_ms),
                            mode="dh 256 instantiation (each block owns half the head dim); parity at dh "
                                 "8, 12, 24, 48, 96 (staged) and 256, f32 and bf16, max_abs_err over dh 256 "
                                 "and [mfu-peak]'s node attention; launches in "
                                 f"{PEAK_STEPS} [mfu-peak] flash steps",
                            shape=f"bf16 B={PEAK_B} H={PEAK_WIDTH['n_heads']} dh=256 L={PEAK_L}, "
                                  "[mfu-peak]'s node attention",
                            library=f"SDPA with the float mask, backend {widths['sdpa_backend']}: {widths['sdpa_kernels']}",
                            mfu_peak_step={k: {"ms": v[0], "peak_gib": v[1], "launches_per_step": v[2],
                                               "step_peak_gib": v[3]} for k, v in peak_flash.items()},
                            ragged_trfold_launches=widths["flash_launches"][part]))
        timed = widths["chunked"][timed_dh]
        k_ms, p_ms, lib_ms, b_ms, b_by = timed["flash_ms"][part]
        kernels.append(dict(entry(f"flash_attn_{part}_chunked", "flash_attn.cu", replaces,
                                  round(peak_chunked["flash"][2][part] * PEAK_STEPS),
                                  widths["flash_err_chunked"][part], k_ms, p_ms, b_ms, b_by, lib_ms),
                            mode="chunked route: dh > 256 at round_up(dh, 128), head-dim chunks of 128 "
                                 "bytes through a cp.async ring, each block owning 128 output columns "
                                 "(q k^T recomputed dh_p/128 times); parity at dh 257, 320, 512, 1000, "
                                 "2048, f32 and bf16, and at [mfu-peak]'s node attention at dh 512 and "
                                 f"2048; launches in {PEAK_STEPS} [mfu-peak] flash steps over "
                                 f"{PEAK_CHUNKED_HEADS} heads",
                            shape=f"bf16 B={PEAK_B} H={timed_heads} dh={timed_dh} L={PEAK_L}, "
                                  f"[mfu-peak]'s node attention over {timed_heads} heads",
                            bound_count="the work counted once: 2 (K8) or 4 (K9) products over the logical dh",
                            recompute_factor={dh: -(-dh // 128) for dh in widths["chunked"]},
                            plain_faster_at_dh=plain_faster(widths["chunked"], part),
                            library=f"SDPA with the float mask, backend {timed['sdpa_backend']}",
                            timed_dh={dh: {"heads": c["heads"], "ms": c["flash_ms"][part][0],
                                           "plain_ms": c["flash_ms"][part][1], "library_ms": c["flash_ms"][part][2],
                                           "bound_ms": c["flash_ms"][part][3], "sdpa_backend": c["sdpa_backend"],
                                           "device_ms": c["device_ms"]}
                                      for dh, c in widths["chunked"].items()},
                            mfu_peak_step={k: {"ms": v[0], "peak_gib": v[1], "launches_per_step": v[2],
                                               "step_peak_gib": v[3]} for k, v in peak_chunked.items()}))
    return kernels


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 1
    modes = ("--flash-timing", "--tri-timing", "--pair-timing", "--grad-timing", "--serve", "--batch-api",
             "--design", "--scale-out", "--model-parallel", "--host", "--widths")
    if sys.argv[1:] not in ([], *([m] for m in modes)):
        print(f"usage: python3 chip_smoke.py [{' | '.join(modes)}]", file=sys.stderr)
        return 2
    flash_only = sys.argv[1:] == ["--flash-timing"]
    tri_only = sys.argv[1:] == ["--tri-timing"]
    sys.path.insert(0, str(REPO))
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.__main__ import serve_loop
    from protstruc_tpu_torch.models.trfold import featurize_for_model, loss_fn
    from protstruc_tpu_torch.models.ipa import fold_loss_fn
    from protstruc_tpu_torch.experiments import kernel_probe
    from protstruc_tpu_torch.ops import cuda_lib, flash_attn, model_features, pair_maps, tri_mul
    from protstruc_tpu_torch.ops.pair_maps import MAP_NAMES, _pair_maps_plain, pairwise_maps
    from protstruc_tpu_torch.utils.aot import precompile_featurizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    say(smi)
    say(f"phase 1 device: {kind} sm_{cap[0]}{cap[1]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()} [{smi}]")
    check(cap == (9, 0), f"the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
    if flash_only:
        t0 = time.perf_counter()
        flash_attn.load_library()
        say(f"flash timing of {REPO}: {flash_attn.library_path().name} built or loaded in "
            f"{time.perf_counter() - t0:.2f} s")
        for ln in cuda_lib.ptxas_lines(flash_attn.library_path().with_suffix(".log")):
            say(f"  ptxas: {ln}")
        flash_phase13(torch, dev, flash_attn, smi)
        # [mfu-peak]'s node attention: dh 256, and in a tree with the chunked
        # route CHUNKED_TIMED
        node_attention_timing(torch, dev, flash_attn, smi, PEAK_WIDTH["n_heads"], "flash timing")
        if hasattr(flash_attn, "head_dim_route"):
            for heads, dh in CHUNKED_TIMED:
                node_attention_timing(torch, dev, flash_attn, smi, heads, "flash timing", dh)
        return 0
    if sys.argv[1:] == ["--pair-timing"]:
        pair_timing(torch, dev, smi)
        return 0
    if sys.argv[1:] == ["--grad-timing"]:
        grad_timing(torch, dev, smi)
        return 0
    if sys.argv[1:] == ["--serve"]:
        with tempfile.TemporaryDirectory() as tmp:
            work_dir = pathlib.Path(tmp)
            say(f"serve: phase 12's checkpoint: {fold_main_path(dev, work_dir)[0]}")
            served_path(torch, dev, smi, work_dir / "ck", work_dir)
        return 0
    if sys.argv[1:] == ["--batch-api"]:
        t0 = time.perf_counter()
        pair_maps.load_library()
        batch_api_phase(torch, np, dev, smi)
        say(f"phase 19 batch API at BASELINE sizes: ok in {time.perf_counter() - t0:.2f} s (K1 built or loaded)")
        return 0
    if sys.argv[1:] == ["--design"]:
        t0 = time.perf_counter()
        flash_attn.load_library()
        design_phase(torch, dev, smi)
        say(f"phase 20 design path: ok in {time.perf_counter() - t0:.2f} s (K8/K9 built or loaded)")
        return 0
    if sys.argv[1:] == ["--scale-out"]:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            list(ex.map(lambda load: load(), (pair_maps.load_library, tri_mul.load_library,
                                              flash_attn.load_library)))
        say(f"phase 21: K1, K4-K7 and K8/K9 built or loaded in {time.perf_counter() - t0:.2f} s")
        for ln in cuda_lib.ptxas_lines(cuda_lib.library_path("pair_maps", pair_maps._SOURCES).with_suffix(".log")):
            say(f"  ptxas: {ln}")
        scale_out_phase(torch, np, dev, smi)
        return 0
    if sys.argv[1:] == ["--model-parallel"]:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            list(ex.map(lambda load: load(), (model_features.load_library, tri_mul.load_library,
                                              flash_attn.load_library)))
        say(f"phase 22: K3, K4-K7 and K8/K9 built or loaded in {time.perf_counter() - t0:.2f} s")
        model_parallel_phase(torch, np, dev, smi)
        return 0
    if sys.argv[1:] == ["--host"]:
        t0 = time.perf_counter()
        pair_maps.load_library()
        say(f"phase 23: K1 built or loaded in {time.perf_counter() - t0:.2f} s")
        host_phase(torch, np, dev, smi)
        return 0
    if sys.argv[1:] == ["--widths"]:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            list(ex.map(lambda load: load(), (pair_maps.load_library, tri_mul.load_library,
                                              flash_attn.load_library)))
        say(f"phase 24: K1, K4-K7 and K8/K9 built or loaded in {time.perf_counter() - t0:.2f} s")
        for lib in (tri_mul, flash_attn):
            for ln in cuda_lib.ptxas_lines(lib.library_path().with_suffix(".log")):
                say(f"  ptxas: {ln}")
        width_phase(torch, np, dev, smi)
        return 0
    if tri_only:
        t0 = time.perf_counter()
        pair_maps.load_library()
        tri_mul.load_library()
        say(f"tri timing of {REPO}: {tri_mul.library_path().name} built or loaded in "
            f"{time.perf_counter() - t0:.2f} s")
        for ln in cuda_lib.ptxas_lines(tri_mul.library_path().with_suffix(".log")):
            say(f"  ptxas: {ln}")
        feats, models, init = train_models(torch, dev, dict(TRAIN_WIDTH, dtype=torch.bfloat16),
                                           train_xyz(np))
        train_step_timing(torch, smi, models, feats, init)
        del models, feats, init
        torch.cuda.empty_cache()
        tri_timings(torch, dev, smi, dict.fromkeys(TRI_KERNELS, 0.0))
        tri_wide_timings(torch, dev, smi, tri_mul)
        f32_train_step(torch, np, dev, smi, tri_mul)
        tri_timings(torch, dev, smi, dict.fromkeys(TRI_KERNELS, 0.0), torch.float32)
        tri_wide_timings(torch, dev, smi, tri_mul, torch.float32)
        tri_timings(torch, dev, smi, dict.fromkeys(TRI_KERNELS, 0.0), torch.float32, C=64, L=256,
                    phase="FoldModel shape")
        from protstruc_tpu_torch.train import TrainConfig
        fold_cfg = TrainConfig(batch_size=4, crop_len=256, node_dim=128, pair_dim=64, n_blocks=4,
                               n_recycle=1, pair_update="triangle", remat=True, fused_tri=True,
                               use_flash_attn=True, seed=0)  # FOLD_ARGV's
        fold_step_timing(torch, smi, *fold_models(torch, dev, fold_cfg), fold_cfg.crop_len)
        return 0

    # -- 2. build -------------------------------------------------------------
    builds = build_all(cuda_lib, pair_maps, tri_mul, model_features, flash_attn, kernel_probe)
    for name, kernels in (("pair_maps", "K1"), ("pair_maps_bwd", "K2"), ("pair_maps_probe", "P1-P3"),
                          ("model_features", "K3"), ("tri_mul", "K4-K7"), ("flash_attn", "K8/K9")):
        lib_path, how, build_s = builds[name]
        say(f"phase 2 build: {how} {lib_path.name} ({kernels}) in {build_s:.2f} s "
            f"({cuda_lib.find_nvcc()}, the {len(builds)} started together)")
        for ln in cuda_lib.ptxas_lines(lib_path.with_suffix(".log")):
            say(f"  ptxas: {ln}")

    # -- 3. parity at small sizes ---------------------------------------------
    rng = np.random.RandomState(1)
    small = {f"B2 L{L}": torch.from_numpy((rng.randn(2, L, 15, 3) * 10).astype(np.float32)).to(dev)
             for L in (37, 300)}   # phases 14 and 17 take these two as they were
    rng = np.random.RandomState(5)
    small.update({f"B2 L{L}": torch.from_numpy((rng.randn(2, L, 15, 3) * 10).astype(np.float32)).to(dev)
                  for L in PAIR_LENGTHS if f"B2 L{L}" not in small})
    small["probes"] = probes(torch, dev)
    worst_small = 0.0
    for label, x in small.items():
        got = pairwise_maps(x)
        torch.cuda.synchronize()
        ref = _pair_maps_plain(x)
        worst_small = max(worst_small, compare_maps(ref, got, label))
        say(f"  {label}: {store_path(x.shape[1])} stores; unequal entries vs plain "
            f"{k1_bitwise(ref, got, label)}")
    sub = pairwise_maps(small["B2 L300"], maps=("d_cb", "phi"))
    full = pairwise_maps(small["B2 L300"])
    check(tuple(sub) == ("d_cb", "phi"), "map subset order")
    for k in sub:
        check(torch.equal(sub[k].nan_to_num(), full[k].nan_to_num()), f"subset {k} differs")
    for label in ("B2 L37", "B2 L300"):
        for dt in (torch.float32, torch.bfloat16):
            k1_subset_writes(torch, pair_maps, small[label], ("d_cb", "phi"), dt)
    k1_bf16_gate(torch, pair_maps, small["B2 L37"], "B2 L37")
    say(f"phase 3 parity small: ok, max err {worst_small:.3e}, every map bitwise equal to plain at "
        f"L = {', '.join(map(str, PAIR_LENGTHS))} and the probes; map subset ok (only the selected "
        f"planes written, f32 and bf16); bf16 mode = f32 planes cast at L=37")

    # -- 4. parity at full size -----------------------------------------------
    xyz_np = np.random.RandomState(0).randn(B_FULL, L_FULL, 15, 3).astype(np.float32) * 10
    xyz = torch.from_numpy(xyz_np).to(dev)
    got = pairwise_maps(xyz)
    torch.cuda.synchronize()
    worst_full, above, full_unequal = 0.0, {k: 0 for k in got}, 0
    chunk = 32
    for b0 in range(0, B_FULL, chunk):
        ref = _pair_maps_plain(xyz[b0:b0 + chunk])
        for k in ref:
            err, n = compare(ref[k], got[k][b0:b0 + chunk], f"full {k}")
            worst_full = max(worst_full, err)
            above[k] += n
        full_unequal += k1_bitwise(ref, {k: v[b0:b0 + chunk] for k, v in got.items()}, "full")
        del ref
    del got
    bf16_unequal = k1_bf16_gate(torch, pair_maps, xyz, "full")
    say(f"phase 4 parity full B={B_FULL} L={L_FULL}: ok, max err {worst_full:.3e}; "
        f"entries above 1e-5: {above}; unequal entries vs plain {full_unequal}; "
        f"bf16 mode vs f32 planes cast: {bf16_unequal} unequal")

    # -- 5. main path ---------------------------------------------------------
    paths = [str(DATA / p) for p in PDBS]
    cpu_sb = pt.StructureBatch.from_pdb(paths, device="cpu")
    cpu_g = cpu_sb.inter_residue_geometry(use_kernel=True)
    cpu_d, cpu_m = cpu_sb.backbone_dihedrals()
    cpu_f = cpu_sb.backbone_orientations()
    singles = {p: pt.StructureBatch.from_pdb(str(DATA / p), device="cpu") for p in PDBS[:2]}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        reqs = [{"op": "ping"}]
        reqs += [{"op": "featurize", "path": str(DATA / p), "out": str(tmp / f"{p}.npz")}
                 for p in singles]
        reqs += [{"op": "featurize", "path": str(tmp / "missing.pdb"), "out": str(tmp / "x.npz")},
                 {"op": "analyze", "path": str(DATA / PDBS[0])},
                 {"op": "shutdown"}]
        out = io.StringIO()

        pair_maps.LAUNCHES = pair_maps.BF16_LAUNCHES = 0
        t0 = time.perf_counter()
        sb = pt.StructureBatch.from_pdb(paths, device="cuda")
        g = sb.inter_residue_geometry(use_kernel=True)
        d, m = sb.backbone_dihedrals()
        frames = sb.backbone_orientations()
        torch.cuda.synchronize()
        feat = precompile_featurizer(batch_sizes=(1,), buckets=(256, 512), device="cuda")
        rc = serve_loop(io.StringIO("\n".join(json.dumps(r) for r in reqs)), out,
                        buckets=(256, 512), device="cuda")
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches, bf16_launches = pair_maps.LAUNCHES, pair_maps.BF16_LAUNCHES

        check(sb.device.type == "cuda" and g["d_cb"].is_cuda, "main path did not run on the card")
        compare_maps(cpu_g, {k: v.cpu() for k, v in g.items()},
                     f"from_pdb B={sb.batch_size} L={sb.n_residues} vs CPU")
        compare(cpu_d, d.cpu(), "dihedrals")
        compare(cpu_m, m.cpu(), "dihedral_mask")
        compare(cpu_f, frames.cpu(), "frames")
        check(feat.shapes == [(1, 256), (1, 512)], f"warmed shapes {feat.shapes}")

        check(rc == 0, f"serve_loop returned {rc}")
        lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
        check(len(lines) == len(reqs) + 1, f"{len(lines)} replies to {len(reqs)} requests")
        check(lines[0] == {"ok": True, "ready": True, "shapes": [[1, 256], [1, 512]]},
              f"ready line {lines[0]}")
        check(lines[1] == {"ok": True}, f"ping reply {lines[1]}")
        for reply, (p, single) in zip(lines[2:4], singles.items()):
            check(reply.get("ok") and reply["n_residues"] == single.n_residues,
                  f"featurize {p}: {reply}")
            npz = np.load(reply["out"])
            ref = dict(single.inter_residue_geometry(use_kernel=True))
            ref["dihedrals"], ref["dihedral_mask"] = single.backbone_dihedrals()
            ref["frames"] = single.backbone_orientations()
            check(sorted(npz.files) == sorted(ref), f"npz keys {sorted(npz.files)}")
            compare_maps(ref, {k: torch.from_numpy(npz[k]) for k in ref}, f"served {p}")
        check(not lines[4]["ok"] and lines[4]["error"].startswith("FileNotFoundError"),
              f"bad path reply {lines[4]}")
        check(lines[5].get("ok") and lines[5]["n_residues"] == singles[PDBS[0]].n_residues,
              f"analyze reply {lines[5]}")
        check(lines[6] == {"ok": True, "bye": True}, f"shutdown reply {lines[6]}")
    check(launches > 0, "the main path launched K1 no time")
    check(bf16_launches == 0, f"the main path launched K1's bf16 mode {bf16_launches} times (it serves f32 maps)")
    say(f"phase 5 main path: ok in {main_s:.2f} s; {len(reqs)} requests served; "
        f"K1 launches {launches} (f32), bf16 mode {bf16_launches}")

    # -- 6. timing ------------------------------------------------------------
    plain_ms, kernel_ms, rounds = alternate(lambda: _pair_maps_plain(xyz), lambda: pairwise_maps(xyz))
    say(f"phase 6 timing K1 B={B_FULL} L={L_FULL} [{smi}]: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)}); "
        f"{store_path(L_FULL)} stores")
    bf16_ms = cuda_time_ms(lambda: pair_maps.pairwise_maps_forward(xyz, out_dtype=torch.bfloat16))
    bf16_bound = bound(slot_bytes(xyz, K1_SLOTS) + 6 * B_FULL * L_FULL ** 2 * 2,
                       K1_OPS_PER_PAIR * B_FULL * L_FULL ** 2, torch.float32)
    say(f"phase 6 timing K1 bf16 mode B={B_FULL} L={L_FULL} six maps [{smi}]: kernel {bf16_ms:.4f} ms; "
        f"bound {bf16_bound[0]:.4f} ms ({bf16_bound[1]}); {store_path(L_FULL)} stores")
    featurize_timing(torch, xyz, smi, kernel_ms)

    # -- 7. triangle kernels ---------------------------------------------------
    tri_worst = tri_kernel_parity(torch, dev)
    say(f"phase 7 parity K4-K7: ok, max abs err {tri_worst}")

    # -- 8. train path ---------------------------------------------------------
    cfg = dict(TRAIN_WIDTH, dtype=torch.bfloat16)
    pair_maps.LAUNCHES = 0
    for k in tri_mul.LAUNCHES:
        tri_mul.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    feats, models, init = train_models(torch, dev, cfg, train_xyz(np))
    fused_losses = run_steps(feats, models[True], TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(tri_mul.LAUNCHES)
    k1_train = pair_maps.LAUNCHES
    check(feats["d_cb"].is_cuda, "the train path did not featurize on the card")
    check(all(np.isfinite(fused_losses)), f"non-finite losses {fused_losses}")
    for k, n in train_launches.items():
        check(n > 0, f"the train path launched {k} no time")
    check(k1_train > 0, "the train path launched K1 no time")
    plain_losses = run_steps(feats, models[False], TRAIN_STEPS)
    compare_losses(fused_losses, plain_losses, 2e-2, "bf16 B=4 L=512")
    say(f"phase 8 train path bf16 B=4 L={L_FULL} {TRAIN_WIDTH}: ok in {train_s:.2f} s; "
        f"losses fused {fused_losses}, unfused {plain_losses}; launches K1 {k1_train}, "
        f"{train_launches}")

    xyz_small = np.random.RandomState(3).randn(1, 128, 15, 3).astype(np.float32) * 5.0
    feats32, models32, _ = train_models(torch, dev, dict(TRAIN_WIDTH, dtype=torch.float32), xyz_small)
    grads = {}
    for fused, (model, params, _, _) in models32.items():
        loss_fn(params, model, feats32).backward()
        grads[fused] = {k: p.grad.detach().clone() for k, p in params.items()}
        model.zero_grad(set_to_none=True)
    worst_leaf, worst_rel = grad_error(torch, grads[False], grads[True])
    check(worst_rel <= 1e-4, f"f32 gradient of {worst_leaf}: relative error {worst_rel:.3e} > 1e-4")
    l32 = {fused: run_steps(feats32, entry, TRAIN_STEPS) for fused, entry in models32.items()}
    compare_losses(l32[True], l32[False], 1e-5, "f32 B=1 L=128")
    say(f"phase 8 train path f32 B=1 L=128: ok; losses fused {l32[True]}, unfused {l32[False]}; "
        f"largest relative gradient error {worst_rel:.3e} ({worst_leaf}) over {len(grads[True])} leaves")
    del feats32, models32, grads

    # -- 9. timing: train step and K4-K7 ---------------------------------------
    train_step_timing(torch, smi, models, feats, init)
    del models, feats, init
    torch.cuda.empty_cache()
    tri_ms, _ = tri_timings(torch, dev, smi, tri_worst)

    # -- 9b. the same in float32: K4-K7 on the wide route ----------------------
    check(f32_wide_tree(torch, dev, tri_mul), "f32 K5 and K7 at C = 128 do not take the wide route")
    f32_routes, f32_step = f32_train_step(torch, np, dev, smi, tri_mul)
    tri32_worst = dict.fromkeys(TRI_KERNELS, 0.0)
    tri32_ms, tri32_split = tri_timings(torch, dev, smi, tri32_worst, torch.float32)

    # -- 10. K3 ------------------------------------------------------------------
    t0 = time.perf_counter()
    k3_worst, k3_mismatches = k3_parity(torch, dev)
    say(f"phase 10 parity K3: ok in {time.perf_counter() - t0:.2f} s, max plane err {k3_worst:.3e}, "
        f"{k3_mismatches} bins differ (each within {K3_EDGE} A of an edge)")

    # -- 11. K8/K9 ---------------------------------------------------------------
    t0 = time.perf_counter()
    flash_worst = flash_parity(torch, dev)
    say(f"phase 11 parity K8/K9: ok in {time.perf_counter() - t0:.2f} s, max abs err {flash_worst}")

    # -- 12. main path of the FoldModel slice -------------------------------------
    counters = (model_features, tri_mul, flash_attn)
    work = tempfile.TemporaryDirectory()  # phase 12's checkpoint, served again in phase 18
    work_dir = pathlib.Path(work.name)
    reset_launches(*counters)
    t0 = time.perf_counter()
    metrics, fold_losses, evals, fold_cfg, fold_line = fold_main_path(dev, work_dir)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    fold_launches = {"model_features": model_features.LAUNCHES,
                     **{f"tri_mul_{k}": n for k, n in tri_mul.LAUNCHES.items()},
                     **{f"flash_attn_{k}": n for k, n in flash_attn.LAUNCHES.items()}}
    for k, n in fold_launches.items():
        check(n > 0, f"the FoldModel main path launched {k} no time")
    say(f"phase 12 main path train -> fold: ok in {fold_s:.2f} s; {metrics}; losses {fold_losses}; "
        f"evals {evals}; fold: {fold_line}; launches {fold_launches}")

    sb, fold_models_, fold_init = fold_models(torch, dev, fold_cfg)
    fold_loss, fold_grads = {}, {}
    for kernel, (model, c) in fold_models_.items():
        feats, xyz_true = fold_featurize(torch, sb, model, c, kernel)
        params = dict(model.named_parameters())
        loss = fold_loss_fn(params, model, feats, xyz_true)
        loss.backward()
        fold_loss[kernel] = float(loss.detach())
        fold_grads[kernel] = {k: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                              for k, p in params.items()}
        model.zero_grad(set_to_none=True)
    loss_rel = abs(fold_loss[True] - fold_loss[False]) / abs(fold_loss[False])
    check(math.isfinite(fold_loss[True]) and loss_rel <= 1e-4,
          f"FoldModel loss: kernel path {fold_loss[True]!r} vs plain {fold_loss[False]!r}")
    leaf, leaf_rel = grad_error(torch, fold_grads[False], fold_grads[True])
    check(leaf_rel <= 1e-3, f"FoldModel gradient of {leaf}: relative error {leaf_rel:.3e} > 1e-3")
    say(f"phase 12 kernel vs plain path, one batch of {BATCH_FILES} cropped to {fold_cfg.crop_len}: "
        f"loss {fold_loss[True]!r} vs {fold_loss[False]!r} ({loss_rel:.3e} relative); largest "
        f"relative gradient error {leaf_rel:.3e} ({leaf}) over {len(fold_grads[True])} leaves")
    del fold_grads

    # -- 13. timing ----------------------------------------------------------------
    fold_step_timing(torch, smi, sb, fold_models_, fold_init, fold_cfg.crop_len)
    del fold_models_, fold_init, sb
    torch.cuda.empty_cache()

    k3_plain_ms, k3_ms, rounds = alternate(lambda: model_features._model_features_plain(xyz),
                                           lambda: model_features.model_features(xyz))
    bins, ang = model_features.model_features(xyz)
    k3_bound = bound(slot_bytes(xyz, K3_SLOTS) + nbytes(bins, ang),
                     K3_OPS_PER_PAIR * B_FULL * L_FULL ** 2, torch.float32)
    del bins, ang
    say(f"phase 13 timing K3 B={B_FULL} L={L_FULL} bf16 planes [{smi}]: kernel {k3_ms:.4f} ms, plain "
        f"{k3_plain_ms:.4f} ms (plain/kernel/kernel/plain {', '.join(f'{r:.4f}' for r in rounds)}); "
        f"bound {k3_bound[0]:.4f} ms ({k3_bound[1]}); {store_path(L_FULL)} stores")

    flash_ms = flash_phase13(torch, dev, flash_attn, smi)

    # -- 14. K2 parity ---------------------------------------------------------------
    k2_worst, g_full = k2_parity(torch, dev, pair_maps, small, xyz)

    # -- 15. main path: gradient through features ------------------------------------
    weights = dict(zip(MAP_NAMES, np.random.RandomState(4).randn(6).tolist()))
    pair_maps.LAUNCHES = pair_maps.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    sb = pt.StructureBatch.from_pdb(paths, device="cuda")
    grad_runs = {}
    for label, leaf in (("raw", sb.xyz.detach().clone()),
                        ("missing atoms at 0", torch.nan_to_num(sb.xyz.detach()))):
        leaf.requires_grad_()
        g = dataclasses.replace(sb, xyz=leaf).inter_residue_geometry(use_kernel=True)
        loss, cots = masked_map_loss(torch, g, weights)
        loss.backward()
        grad_runs[label] = (leaf, cots, float(loss))
    sbt = pt.StructureBatch.from_xyz(np.random.RandomState(0).randn(4, L_FULL, 15, 3).astype(np.float32) * 5,
                                     device=dev)
    sbt.xyz.requires_grad_()
    feats = featurize_for_model(sbt, use_kernel=True)
    loss, cots = masked_map_loss(torch, feats, {k: weights[k] for k in ("d_cb", "omega", "theta", "phi")})
    loss.backward()
    grad_runs["featurize_for_model B=4 L=512"] = (sbt.xyz, cots, float(loss))
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = {"pair_maps": pair_maps.LAUNCHES, "pair_maps_bwd": pair_maps.BWD_LAUNCHES}
    for k, n in grad_launches.items():
        check(n > 0, f"the gradient-through-features path launched {k} no time")
    for label, (leaf, cots, loss_v) in grad_runs.items():
        check(math.isfinite(loss_v) and leaf.grad is not None and leaf.grad.is_cuda,
              f"{label}: loss {loss_v}, no gradient on the card")
        err, top = k2_check(torch, pair_maps._maps_bwd_plain(leaf.detach(), cots), leaf.grad,
                            f"gradient {label}")
        if label != "raw":
            check(bool(torch.isfinite(leaf.grad).all()), f"gradient {label}: non-finite entries")
        k2_worst = max(k2_worst, err)
        say(f"  phase 15 {label}: loss {loss_v:.6e}; xyz.grad vs the plain backward of the same "
            f"cotangents max err {err:.3e} (max|ref| {top:.3e}); finite entries "
            f"{int(torch.isfinite(leaf.grad).sum())} of {leaf.grad.numel()}")
    say(f"phase 15 main path gradient through features: ok in {grad_s:.2f} s (from_pdb {PDBS} -> "
        f"inter_residue_geometry(use_kernel=True) -> masked loss -> backward, raw and with missing atoms "
        f"at 0; featurize_for_model(use_kernel=True) B=4 L={L_FULL}); launches {grad_launches}")
    del grad_runs, feats, sbt, sb

    # -- 16. timing: K2, the forward and backward ---------------------------------------
    k2_plain_chunks = [(xyz[b0:b0 + 64], {k: v[b0:b0 + 64] for k, v in g_full.items()})
                       for b0 in range(0, B_FULL, 64)]
    k2_plain_ms, k2_ms, rounds = alternate(
        lambda: [pair_maps._maps_bwd_plain(*c) for c in k2_plain_chunks],
        lambda: pair_maps.maps_bwd(xyz, g_full))
    got = pair_maps.maps_bwd(xyz, g_full)
    k2_bound = bound(slot_bytes(xyz, K2_SLOTS) + nbytes(*g_full.values(), got),
                     K2_OPS_PER_PAIR * B_FULL * L_FULL ** 2, torch.float32)
    del got
    say(f"phase 16 timing K2 B={B_FULL} L={L_FULL} six maps [{smi}]: kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms (the plain version as 4 calls of 64 structures; plain/kernel/kernel/plain "
        f"{', '.join(f'{r:.4f}' for r in rounds)}); bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    leaf = xyz.detach().clone().requires_grad_()

    def fwd_bwd():
        maps = pairwise_maps(leaf)
        torch.autograd.backward([maps[k] for k in MAP_NAMES], [g_full[k] for k in MAP_NAMES])
        leaf.grad = None

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    fwd_bwd()
    torch.cuda.synchronize()
    fb_peak = torch.cuda.max_memory_allocated() / 2**30
    fb_ms = cuda_time_ms(fwd_bwd)
    say(f"phase 16 timing pairwise_maps forward + backward through autograd B={B_FULL} L={L_FULL} [{smi}]: "
        f"{fb_ms:.4f} ms (K1 {kernel_ms:.4f} + K2 {k2_ms:.4f} alone); peak {fb_peak:.2f} GiB "
        f"({base_gib:.2f} GiB held before: xyz, the six cotangents and earlier phases' tensors)")
    del leaf, k2_plain_chunks
    torch.cuda.empty_cache()

    # -- 17. the K1 probes -------------------------------------------------------------
    t0 = time.perf_counter()
    probe_err = {"run_variant": 0.0, "run_packed_variant": 0.0, "tile_sweep": 0.0}
    kp = kernel_probe
    for label in ("B2 L37", "B2 L300"):
        x = small[label]
        for variant in kp.VARIANTS:
            probe_err["run_variant"] = max(probe_err["run_variant"], compare_maps(
                kp.probe_plain(x, variant), kp.probe(x, variant), f"probe {variant} {label}"))
        dist3 = ("d_ca", "d_cb", "d_no")
        probe_err["run_variant"] = max(probe_err["run_variant"], compare_maps(
            kp.probe_plain(x, "full", dist3), kp.probe(x, "full", dist3), f"probe dist3 {label}"))
        for name, (variant, block) in kp.packed_variants().items():
            ref = kp.probe_plain(x, variant, packed=True)
            got = kp.probe(x, variant, block=block, packed=True)
            probe_err["run_packed_variant"] = max(probe_err["run_packed_variant"], compare_maps(
                dict(zip(MAP_NAMES, ref.unbind(1))), dict(zip(MAP_NAMES, got.unbind(1))),
                f"probe {name} {label}"))
        for variant in ("full", "write-only"):
            for block in kp.SWEEP_BLOCKS:
                probe_err["tile_sweep"] = max(probe_err["tile_sweep"], compare_maps(
                    kp.probe_plain(x, variant), kp.probe(x, variant, block=block),
                    f"probe {variant} {block} {label}"))
    torch.cuda.synchronize()
    say(f"phase 17 parity probes: ok in {time.perf_counter() - t0:.2f} s, max abs err {probe_err}")

    def log17(line):
        say(f"  phase 17 [{smi}] {line}")

    probe_ms, probe_launches = {}, {}
    kp.LAUNCHES = 0
    p1 = {"full": kp.run_variant("full", xyz, "full", log=log17),
          "write-only": kp.run_variant("write-only", xyz, "write-only", log=log17),
          "dist3": kp.run_variant("dist3", xyz, "full", maps=("d_ca", "d_cb", "d_no"), log=log17)}
    for rep_ in range(2):
        for variant in [v for v in kp.VARIANTS if v.startswith("opt")] + ["full"]:
            p1[variant] = min(p1.get(variant, float("inf")),
                              kp.run_variant(f"{variant}#{rep_}", xyz, variant, log=log17))
    probe_launches["run_variant"] = kp.LAUNCHES
    kp.LAUNCHES = 0
    p2 = {name: kp.run_packed_variant(name, xyz, variant, block, log=log17)
          for name, (variant, block) in kp.packed_variants().items()}
    probe_launches["run_packed_variant"] = kp.LAUNCHES
    kp.LAUNCHES = 0
    p3 = kp.tile_sweep(xyz, log=log17)
    probe_launches["tile_sweep"] = kp.LAUNCHES
    for k, n in probe_launches.items():
        check(n > 0, f"the probe path launched {k} no time")
    for name, ms in sorted(p1.items(), key=lambda kv: kv[1]):
        say(f"  phase 17 BEST {name:>14}: {ms:.4f} ms ({B_FULL / ms * 1e3:.0f} structures/s)")
    maps_bytes = 6 * B_FULL * L_FULL ** 2 * 4
    for site, table, wo in (("run_variant", p1, p1["write-only"]),
                            ("run_packed_variant", p2, p2["write-only-packed"]),
                            ("tile_sweep", {f"full {b}": ms for (v, b), ms in p3.items() if v == "full"},
                             min(ms for (v, _), ms in p3.items() if v == "write-only"))):
        best = min((n for n in table if "write-only" not in n and n != "dist3"), key=table.get)
        variant = "full" if best.startswith("full") else best
        packed = site == "run_packed_variant"
        plain_ms_p = cuda_time_ms(lambda: kp.probe_plain(xyz, variant, packed=packed))
        b = bound(slot_bytes(xyz, K1_SLOTS) + maps_bytes,
                  (K1_OPS_PER_PAIR - 3 * 15 + 3 * PROBE_ATAN2_OPS[variant]) * B_FULL * L_FULL ** 2,
                  torch.float32)
        probe_ms[site] = (best, table[best], wo, plain_ms_p, *b)
        say(f"phase 17 probes {site} [{smi}]: fastest {best} {table[best]:.4f} ms (plain {plain_ms_p:.4f} ms), "
            f"write-only {wo:.4f} ms: stores {100 * wo / table[best]:.1f}% of the fastest's time; "
            f"bound {b[0]:.4f} ms ({b[1]}); launches {probe_launches[site]}")
    say(f"phase 17 K1 split: full {p1['full']:.4f} ms, write-only {p1['write-only']:.4f} ms "
        f"(the stores alone), dist3 {p1['dist3']:.4f} ms (half the stores, a seventh of the arithmetic); "
        f"arithmetic and atan2f beyond the stores {p1['full'] - p1['write-only']:.4f} ms")
    del g_full
    torch.cuda.empty_cache()

    # -- 18. the served and analysis path ------------------------------------------------
    t0 = time.perf_counter()
    served_path(torch, dev, smi, work_dir / "ck", work_dir)
    work.cleanup()
    say(f"phase 18 served and analysis path: ok in {time.perf_counter() - t0:.2f} s")

    # -- 19. the batch API at BASELINE sizes ---------------------------------------------
    t0 = time.perf_counter()
    dcb_entry = batch_api_phase(torch, np, dev, smi)
    say(f"phase 19 batch API at BASELINE sizes: ok in {time.perf_counter() - t0:.2f} s")

    # -- 20. the design and generation path ----------------------------------------------
    t0 = time.perf_counter()
    design = design_phase(torch, dev, smi)
    say(f"phase 20 design path: ok in {time.perf_counter() - t0:.2f} s")

    # -- 21. the scale-out path ----------------------------------------------------------
    scale_out = scale_out_phase(torch, np, dev, smi)

    # -- 22. model parallelism inside FoldModel -------------------------------------------
    model_parallel = model_parallel_phase(torch, np, dev, smi)

    # -- 23. the host layer ---------------------------------------------------------------
    torch.cuda.empty_cache()
    host_phase(torch, np, dev, smi)

    # -- 24. every width the JAX package takes ----------------------------------------------
    torch.cuda.empty_cache()
    widths = width_phase(torch, np, dev, smi)

    k1_bound = bound(slot_bytes(xyz, K1_SLOTS) + 6 * B_FULL * L_FULL ** 2 * 4,
                     K1_OPS_PER_PAIR * B_FULL * L_FULL ** 2, torch.float32)

    def entry(name, source, replaces, launches_, err, ms, plain, bound_ms, bound_by, library_ms):
        return {"name": name, "route": "cuda", "source": f"protstruc_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches_, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}

    kernels = [dict(entry("pair_maps", "pair_maps.cu", "protstruc_tpu/ops/pallas_pairwise.py:146", launches,
                          max(worst_small, worst_full), kernel_ms, plain_ms, *k1_bound, None),
                    bf16_mode={"launches": bf16_launches, "unequal_vs_f32_cast": bf16_unequal, "ms": bf16_ms, "bound_ms": bf16_bound[0],
                               "bound_by": bf16_bound[1]}, dcb_subset=dcb_entry),
               entry("model_features", "model_features.cu", "protstruc_tpu/ops/pallas_pairwise.py:671",
                     fold_launches["model_features"], k3_worst, k3_ms, k3_plain_ms, *k3_bound, None)]
    kernels += [entry(f"tri_mul_{name}", "tri_mul.cu", TRI_REPLACES[name], train_launches[name],
                      tri_worst[name], *tri_ms[name], None) for name in TRI_KERNELS]
    train_flash = flash_ms["train"]
    kernels += [dict(entry(f"flash_attn_{part}", "flash_attn.cu", replaces,
                           fold_launches[f"flash_attn_{part}"], max(flash_worst[part], design["folded"][part]),
                           *train_flash[part][:2], *train_flash[part][3:], train_flash[part][2]),
                     design_if_step_launches=design["launches"][part])
                for part, replaces in (("fwd", "protstruc_tpu/ops/flash_attn.py:79"),
                                       ("bwd", "protstruc_tpu/ops/flash_attn.py:184"))]
    kernels.append(entry("pair_maps_bwd", "pair_maps_bwd.cu", "protstruc_tpu/ops/pallas_pairwise.py:453",
                         grad_launches["pair_maps_bwd"], k2_worst, k2_ms, k2_plain_ms, *k2_bound, None))
    for site, line in (("run_variant", 51), ("run_packed_variant", 227), ("tile_sweep", 329)):
        best, ms, wo, plain, b_ms, b_by = probe_ms[site]
        kernels.append(dict(entry(f"kernel_probe_{site}", "pair_maps_probe.cu",
                                  f"experiments/kernel_probe.py:{line}", probe_launches[site],
                                  probe_err[site], ms, plain, b_ms, b_by, None),
                            variant=best, write_only_ms=wo))
    so, rect = scale_out, scale_out["rect"]
    kernels.append(dict(entry("pair_maps_rect", "pair_maps.cu", "protstruc_tpu/ops/pallas_pairwise.py:146",
                              so["launches"]["rect"], rect["err"], rect["ms"], rect["plain_ms"],
                              *rect["bound"], None),
                        mode="K1 xyz_j (pairwise_maps_pallas(xyz_j=...), pallas_pairwise.py:603-646): "
                             "4 row blocks of B=256 L=512", square_ms=rect["square_ms"]))
    lse_ms, lse_plain, lse_lib, lse_bound = so["lse_ms"]
    kernels.append(dict(entry("flash_attn_lse", "flash_attn.cu", "protstruc_tpu/ops/flash_attn.py:689",
                              so["launches"]["lse_fwd"], so["lse_err"], lse_ms, lse_plain, *lse_bound,
                              lse_lib),
                        mode="K8/K9 through flash_pair_bias_attention_lse (the ring's local step); "
                             "launches: ring_attention_sharded on one rank; ms: the forward at the "
                             "train shape",
                        bwd_launches=so["launches"]["lse_bwd"]))
    mp = model_parallel
    for e in kernels:
        # phase 22: launches on the sharded path; K4-K7's on row blocks too
        if e["name"] in mp["launches"]:
            e["model_parallel_launches"] = mp["launches"][e["name"]]
        if e["name"].startswith("tri_mul_"):
            e["row_block_launches"] = mp["row_launches"][e["name"][len("tri_mul_"):]]
            e["row_block_weight_grad_rel_err"] = mp["tri_row_err"]
    for e in kernels:
        if e["name"].startswith("tri_mul_"):
            name = e["name"][len("tri_mul_"):]
            e["err_c1024_bf16"] = so["tri_err_c1024"][name]
            e["c1024_bf16"] = dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), so["tri_c1024"][name]),
                                   shape="N=2*256*256 C=1024, [mfu-peak]'s pair rows")
    # K4-K7's wide route: launches in phase 21e's [mfu-peak] fused_tri steps
    # (remat none, PEAK_STEPS steps), times at its pair rows
    for name in TRI_KERNELS:
        kernels.append(dict(entry(f"tri_mul_{name}_wide", "tri_mul.cu", TRI_REPLACES[name],
                                  so["wide_launches"][name], so["tri_err_c1024"][name],
                                  *so["tri_c1024"][name], None),
                            mode="wide route: bf16 C > 128, a chain of mma.sync GEMM kernels; parity "
                                 "at C=144, 160, 256 and 1024 on ragged N and at the shape below",
                            shape="N=2*256*256 C=1024, [mfu-peak]'s pair rows",
                            launches_per_step=so["wide_launches"][name] / PEAK_STEPS,
                            device_ms_by_kernel=so["tri_split"][0][name] and dict(so["tri_split"][0][name]),
                            **({"device_ms_by_kernel_missing": so["tri_split"][1][name]}
                               if name in so["tri_split"][1] else {})))
    # float32 at C = 128 (phase 9b: the [mfu-fused] step's rows; all four on
    # the wide route) and C = 1024 (phase 21e), on each kernel's entry; K4-K7
    # on the float32 wide route as entries of their own, launches from phase
    # 9b's one counted step
    res32, split32, why32, err32 = so["wide32"]
    times = ("ms", "plain_ms", "bound_ms", "bound_by")
    for e in kernels:
        if e["name"].startswith("tri_mul_") and e["name"][len("tri_mul_"):] in TRI_KERNELS:
            name = e["name"][len("tri_mul_"):]
            e["f32_c128"] = dict(zip(times, tri32_ms[name]), route=expected_tri_route(torch.float32, 128),
                                 err=tri32_worst[name], bound_count="3xTF32",
                                 shape="N=4*512*512 C=128, [mfu-fused]'s pair rows in float32")
            e["f32_c1024"] = dict(zip(times, res32[name]), err=err32[name], bound_count="3xTF32",
                                  shape="N=2*256*256 C=1024, [mfu-peak]'s pair rows in float32")
    for name, label in (("prologue_fwd", "K4 f32 wide"), ("prologue_bwd", "K5 f32 wide"),
                        ("epilogue_fwd", "K6 f32 wide"), ("epilogue_bwd", "K7 f32 wide")):
        kernels.append(dict(entry(f"tri_mul_{name}_f32_wide", "tri_mul.cu", TRI_REPLACES[name],
                                  f32_routes[name].get("wide", 0), max(tri32_worst[name], err32[name]),
                                  *tri32_ms[name], None),
                            mode=f"{label}: float32 C > 64, the wide chain on the mma.sync core in 3xTF32; "
                                 "parity at C=80, 128, 144, 256 and 1024; launches in phase 9b's one "
                                 "counted float32 [mfu-fused] step",
                            shape="N=4*512*512 C=128, [mfu-fused]'s pair rows in float32",
                            bound_count="3xTF32: three TF32 products a float32 product at 494.7 TFLOP/s",
                            device_ms_by_kernel=dict(tri32_split[name]),
                            c1024=dict(zip(times, res32[name]), shape="N=2*256*256 C=1024",
                                       device_ms_by_kernel=split32[name] and dict(split32[name]),
                                       **({"device_ms_by_kernel_missing": why32[name]} if name in why32 else {})),
                            f32_step={"fused_ms": f32_step[True][0], "unfused_ms": f32_step[False][0],
                                      "fused_peak_gib": f32_step[True][1], "unfused_peak_gib": f32_step[False][1],
                                      "fused_busy_ms": f32_step[True][2], "unfused_busy_ms": f32_step[False][2]}))
    kernels += width_entries(entry, widths)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
