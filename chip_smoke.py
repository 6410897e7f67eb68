#!/usr/bin/env python3
"""Drive the PyTorch port's ECDH serving path, its MSM path, its keygen
path and its sharded MSM path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any failure raises, so the exit code is non-zero):
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: compile (or load) the kernel libraries from zerocaf_tpu_torch/csrc,
     one nvcc process per source, all at once; ptxas' registers and spills,
     and those of the kernels on the 8 x 32-bit core apart; for
     k_bucket_accum, k_padd and k_ladder the 32 x 32 -> 64-bit products
     (IMAD.WIDE.U32), the IMAD.HI of the multiply's carry chains and all
     instructions in their SASS (cuobjdump; static counts: the multiply is
     a rolled loop) beside their counts at commit 4ba3dd9, before the
     core's modulus became a template parameter with p the default (the
     same code), and the
     instructions of one step of that loop; the latency of one dependent
     core multiply (zc_mul_chain, one thread, 4,096 of them), checked
     against the oracle;
  3. kernels: K1-K4 against their plain PyTorch versions at the main path's
     shapes (K1 limb for limb; K2, K3, K4, on the 8 x 32-bit core, against
     the plain versions' canonical limbs; K2 for every chain exponent mod
     p and r - 2 mod r, timed at 32768 and 2^20 lanes with the peak memory
     of one launch), with CUDA-event times of both and, for K3 and K4, the
     time their multiplies' SASS would take at the card's issue rate;
  4. vectors: the 16 Ristretto small multiples, the Elligator sage vector
     and [2]B, byte for byte;
  5. ECDH at batch 32768: public keys by the ladder (K3), shared secrets by
     Engine.dh (K4, with K1/K2 in decode and encode), checked against each
     other and against the oracle on sampled lanes; one invalid peer lane
     must be rejected;
  6. Engine.hash_to_group at batch 32768, sampled lanes against the oracle;
  7. launch counts: every kernel must have run during phases 5-6;
  8. rates: dh and hash_to_group ops/s (median of 11 calls on the host
     clock, with the min and max) and ladder mults/s;
  9. K5 against its plain version (canonical limbs) at 2^16 lanes;
 10. K7's prep kernel (to_field32), K7 and K8 against their plain versions
     at 2^14 points, c = 6, k = 4 (K8 on canonical limbs), and K8 in the
     window-sharded form of rank 3 of 4 (11 windows, 24 doublings a window,
     tail 18), each with its chain bound (its dependent multiply rounds
     times phase 2's latency);
 11. Engine.msm at batch 2^20, c = 6, the MSM main path: points k'_i B
     made by the ladder (K3) and encoded, seeded canonical scalars; the
     aggregate equals the oracle's; an invalid lane makes ok false; pad_msm
     of 2^20 - 3 lanes equals the MSM of those lanes.  K5, K7, its prep
     and K8 must each have launched during these three calls (counts reset
     just before them and read just after);
 12. at 2^14 points the scan route (dense=False) and the dense route give
     the same bytes, equal to the oracle's (launches printed apart);
 13. at the shapes of the 2^20 path: the prep, K7, and K5 on the first
     round of the lane reduction, against their plain versions, then K5's
     time and bound on every round of that reduction, with K8's time;
 14. rates: Engine.msm points/s at 2^20 for c = 5, 6 and 7 (median of 5
     calls on the host clock, with the min and max);
 15. one Engine.msm call at 2^20 under torch.profiler: device busy share,
     the kernels that take the most device time, and K1's, K2's and K8's
     launches and time; then one more call with torch.cat and torch.stack
     wrapped, naming the callers of the copies;
 16. comb table: the signed width-14 table loaded from the cache or built
     from the oracle (seconds printed), uploaded in both layouts;
 17. K6 against its plain version at 32768 lanes: signed width 14 on the
     packed and the rows table, unsigned width 8;
 18. Engine.keygen at batch 32768, the keygen main path: pk equals the
     Ristretto encoding of the ladder's (K3) sk * B on every lane, and the
     oracle on 32 sampled lanes and on the lanes that reduce to
     k = 2^250 - r, 0, 1 and r - 1; sk equals the oracle's reduction.  K6,
     K1 and K2 must each have launched in that call (counts reset just
     before it and read just after);
 19. K10 at 32768 lanes, width 4: its one launch counted, equal to its
     plain version's canonical limbs and, after encoding, to K4 on the same
     windows;
 20. rate: keygen ops/s (median of 11 calls, with the min and max), and
     one Engine.keygen call under torch.profiler;
 21. K9 (one group of 4 windows, fold 0 and 2), K11 (one window) and K12
     (a window pair) against their plain versions at 2^12 points, c = 6,
     then at the shapes of the 2^20 path with their times and bounds, K11
     at its wrapper's lanes (wide_lanes) and K12 at dense_lanes, with the
     time of the kernel and its lane reduction at one wave, two waves and
     dense_lanes lanes; K7 with fold 2 checked at 2^12 and timed at 2^20;
 22. _msm_dense at 2^20 points, c = 6, with k = 1, k = 2, k = 4 and
     single_call=False, fold = 2, and fused_combine=False: each equals the
     oracle's aggregate, with its time and its own launch counts (the k = 1
     and k = 2 calls are K11's and K12's main path);
 23. msm_sharded at 2^20 on one rank over NCCL, dense + shard_combine (the
     pod configuration, K9's main path): equal to the oracle and to
     Engine.msm, K9 launched 11 times, K8 once (the window-sharded
     combine), K7 not at all, the median of 5 calls, one call profiled as
     in phase 15; then dense alone (K7 + K8);
 24. msm_sharded on 4 gloo ranks sharing the card (spawned processes; the
     parent built the kernels), 2^18 points each: every rank's total
     equals the oracle's, K8 launched once a rank, with its launches,
     times and peak memory;
 25. msm_with_checkpoints at 2^16 points in 4 blocks, and the same job
     resumed from its file after block 2, equal to the one-shot MSM.
Kernels on the 8 x 32-bit core (K2-K5, K7-K12) write canonical limbs and
are held against their plain versions' canonical limbs; the others limb
for limb.
The line before the last is a JSON object with one entry per kernel, with
its bound (the larger of its bytes over the memory rate and its field
multiplies and squares, priced at the 8 x 32 core's word products, over
the card's integer multiply rate; bound_ms_22x12 prices them at the 22 x 12
algebra's multiply-adds); the last line is {"ok": true, "device": {...}}.
Needs a CUDA device: there is no CPU path.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

BATCH = 32768                 # Engine default: the serving batch
MUL_LANES = 1 << 16           # K1 and K5 checked at 2^16 lanes
SAMPLE = 32                   # lanes checked against the oracle
TOLERANCE = 0                 # integer limb algebra: kernels equal plain versions
RATE_CALLS = 11               # serving calls timed for each rate (median)
MSM_BATCH = 1 << 20           # the flagship MSM size
MSM_SMALL = 1 << 14           # K7/K8 checks and the route cross-check
MSM_C = 6                     # Engine.msm's default window width
MSM_SWEEP = (5, 6, 7)         # window widths timed at 2^20
MSM_RATE_CALLS = 5
MSM_NWIN = 42                 # windows at c = 6
MSM_CHECK = 1 << 12           # K9, K11 and K12 checked at 2^12 points first
FOLD_CHECKED = 2              # lane rounds folded after K7 / K9 in the checks
CKPT_BATCH = 1 << 16          # msm_with_checkpoints: 4 blocks of 2^14
SEED = 20261016
ECDH_KERNELS = ("mul_tiled", "pow_tiled", "scalar_mul_windowed_stepped",
                "scalar_mul_windowed_signed")
MSM_KERNELS = ("padd_tiled", "to_field32", "bucket_accum_all", "combine_tables")
KEYGEN_KERNELS = ("mul_tiled", "pow_tiled", "fixed_base_mul_stepped")
SOURCE = "zerocaf_tpu_torch/csrc/field_kernels.cu"
MSM_SOURCE = "zerocaf_tpu_torch/csrc/msm_kernels.cu"
TPU_KERNELS = "zerocaf_tpu/ops/pallas/field_kernels.py"
TPU_MSM_KERNELS = "zerocaf_tpu/ops/pallas/msm_kernels.py"

# Work model of the bounds: field multiplies and squares, as a pair
# (multiplies, squares); point operations as in csrc/field.cuh.
MUL = np.array([1, 0])
SQ = np.array([0, 1])
PADD = 10 * MUL                                 # padd_ext
MADD = 8 * MUL                                  # madd
MADD7 = 7 * MUL                                 # madd_affine (the comb)
PDBL_T = 4 * SQ + 4 * MUL                       # pdbl with T
PDBL = 4 * SQ + 3 * MUL                         # pdbl without T
# Integer multiplies of one field multiply and square, on two bases.  The
# 22 x 12 algebra of field.cuh: the 22 x 22 schoolbook plus the three
# folds (12 x (23 + 14 + 5)), and 22 + 231 products plus the folds.  The 8
# x 32 core of field32.cuh, the least work a field multiply needs on this
# card: 64 word products and 8 reduction steps of 5 (m = t0 (-p^-1) and
# m times p's four nonzero low words), and for the square 28 cross
# products, 8 squares and the same reduction.  Only products count: the
# adds and carries ride in the multiply-adds.
OPS_8X32 = (8 * 8 + 8 * 5, 28 + 8 + 8 * 5)
OPS_22X12 = (22 * 22 + 12 * (23 + 14 + 5), 22 + 231 + 12 * (23 + 14 + 5))
PT_BYTES = 4 * 22 * 4                           # one extended point
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
IMAD_PER_SM_CLOCK = 64    # 32-bit integer multiply-add, compute capability 9.0
ISSUE_PER_SM_CLOCK = 4    # warp instructions: four schedulers an SM
CORE_KERNELS = ("k_bucket_accum", "k_padd", "k_ladder")   # on field32.cuh
# Their SASS at commit 4ba3dd9 (sm_90a), before the core's
# modulus became a template parameter: (IMAD.WIDE.U32, IMAD.HI, all
# instructions) by mangled name; the templated core must leave them so.
UNTEMPLATED_SASS = {"_ZN2zc14k_bucket_accumEPKjPKiPiiiii": (2, 170, 2552),
                    "_ZN2zc6k_paddILi1EEEvNS_6PaddInES1_Piii": (43, 146, 4952),
                    "_ZN2zc6k_paddILi2EEEvNS_6PaddInES1_Piii": (43, 146, 4864),
                    "_ZN2zc8k_ladderEPKiS1_iiiPjPii": (19, 420, 7672)}
PTXAS_KERNELS = ("k_pow", "k_combine", "k_mul_chain")     # ptxas report
MUL_CHAIN = 4096              # dependent multiplies of the latency probe
POW_BIG = 1 << 20             # K2's lanes in Engine.msm's decode at 2^20
WATCHED = ("k_mul", "k_pow", "k_combine")   # profiled calls name these apart

# Reference vectors: compressed k*B for k = 0..15, and the Elligator sage
# vector (input bytes, expected point as 52-bit limbs).
SMALL_MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "0200000000000000000000000000000000000000000000000000000000000000",
    "abe4ea98eaaeda5a9c63879cb3c4d9b4a01ed31ac383acefd7ed49861e1a8002",
    "1064fe35b16525f90f1d2f7d3dc448ba31a118f136c53eed88c2e951f1832907",
    "a826cf66461dea21e51187dddd8753299b726a7d4217cb75758aefbf5a2d4f01",
    "4d2e0705a9b47d122f98bd74808d386cf1691bc5407af703dd0c4808038b7f07",
    "f3a3592fde5fa05a881b80b4e732b37c32c7f684a5be33cdb8b7bdaf53db6f04",
    "51626c7960da63010efc5e064e62962f158f59928914fc108257ec2653745e01",
    "d5f8144c1b04954291785be578633a79131752e82afb990bd4a25b41cbd49001",
    "1372ed81add54633970746cd4b38ceb8a3e538b916288ac3d7c0dfbd54a42b06",
    "a83d7a262a80926724a0beb75a5f26e9a622205e6a64730e14ce64c4b2acf704",
    "a6b2712a6e586ab552f7bcf438168304b8b8a3f3b2852a06ae183e6303406503",
    "7876266b939b889c1da827a76da5c220eb1ff934472d35de60c9e4c3528fcc06",
    "11a0f75ab351572b572c38bf073b076aa964cdff70d53ad7588174dae2729306",
    "64f2fb80b45fbf73793e9e8e509f98848ecdb452c98c83c55c5c31fb233d9907",
    "1de5afbe9fd279f1651306d8ac0f68f0cb2689609ccfe8db1636f9481a33e205",
]
TWO_B = "abe4ea98eaaeda5a9c63879cb3c4d9b4a01ed31ac383acefd7ed49861e1a8002"
SAGE_INPUT = "2e2d7c6f887c81c1593f32e2fa31a7b65d4fbbf38f8ab3045ead22fc45743219"
SAGE_POINT = (
    [520984263488427, 2866053035698784, 356812350072736, 1177086814167286,
     17585355348321],
    [2224110940152212, 767723869121786, 2519083920383090, 3478258567033985,
     6072297619626],
    None,
    [3761248848988017, 3474827148739807, 3137090891116602, 1521420215868592,
     8052069914602],
)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int) -> list[float]:
    """Host wall time of each of reps calls, each ended by a synchronize,
    after one warm-up call; sorted.  A serving call's time is mostly host
    launch work, so it is timed per call on the host clock."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


class Roofline:
    """The least time the card could take for some work: the larger of its
    bytes over the memory rate and its integer multiply instructions over
    the card's rate (SMs x 64 a clock x the maximum SM clock).  Work is a
    pair (field multiplies, squares), priced at the 8 x 32 core's word
    products for ``bound_ms`` and at the 22 x 12 algebra's multiply-adds
    for ``bound_ms_22x12``."""

    def __init__(self, sms: int, max_sm_mhz: float):
        self.sms, self.max_sm_mhz = sms, max_sm_mhz
        self.imad_per_s = sms * IMAD_PER_SM_CLOCK * max_sm_mhz * 1e6

    def __call__(self, work, nbytes: float) -> dict:
        muls, sqs = (float(x) for x in work)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3

        def ops_ms(per):
            return (muls * per[0] + sqs * per[1]) / self.imad_per_s * 1e3

        ops = ops_ms(OPS_8X32)
        return {"bound_ms": max(ops, bytes_ms),
                "bound_by": "operations" if ops >= bytes_ms else "bytes",
                "bound_ms_22x12": max(ops_ms(OPS_22X12), bytes_ms)}


def sass_counts(lib_path, kernel: str) -> dict[str, tuple[int, int, int]]:
    """For each function of the built library whose (mangled) name holds
    ``kernel``: (IMAD.WIDE.U32 instructions -- 32 x 32 -> 64-bit products
    --, IMAD.HI instructions -- the high halves of the multiply's PTX
    carry chains --, all instructions) in its SASS (cuobjdump -sass)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        if kernel in name:
            instructions = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", body))
            counts[name] = (body.count("IMAD.WIDE.U32"), body.count("IMAD.HI"),
                            instructions)
    if not counts:
        raise AssertionError(f"{kernel} not found in the SASS of {lib_path}")
    return counts


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """ptxas -v's registers, spill stores and loads and stack frame of each
    compiled entry function, by mangled name."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            report.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report.setdefault(name, {})
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
    return report


def mul_step_instructions(lib_path, kernel: str) -> int | None:
    """Instructions in one step of the core's rolled multiply as the SASS
    of ``kernel`` holds it: the shortest body of a loop (a branch back)
    that multiplies by -p^-1 mod 2^32 (0x12547e1b, the step's m); None if
    there is none."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    steps = []
    for body in sass.split("Function : ")[1:]:
        if kernel not in body.split(None, 1)[0]:
            continue
        code = [(int(m[1], 16), m[2]) for m in
                re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;\n]*);", body)]
        for addr, op in code:
            m = re.search(r"\bBRA(?:\.\S+)?\s+`?\(?0x([0-9a-f]+)", op)
            if m and int(m[1], 16) < addr:
                loop = [o for a, o in code if int(m[1], 16) <= a <= addr]
                if sum("0x12547e1b" in o for o in loop) == 1:
                    steps.append(len(loop))
    return min(steps) if steps else None


def mul_issue_ms(step: int | None, muls: float, sms: int,
                 max_sm_mhz: float) -> float | None:
    """The time the card would take to issue the rolled multiplies alone:
    ``muls`` field multiplies (a square is one) of 8 steps of ``step``
    instructions, a warp instruction for 32 lanes, four warp instructions
    an SM a clock.  A lower bound on the issue time (the additions,
    selections and conversions come on top): a kernel far above it waits
    on latency or memory, not on issue."""
    if step is None:
        return None
    return round(muls * 8 * step / 32
                 / (sms * ISSUE_PER_SM_CLOCK * max_sm_mhz * 1e6) * 1e3, 4)


def canonical(point):
    """A point tuple of [..., 22] limbs -> canonical limbs (the kernels on the
    8 x 32-bit core write those; their plain versions leave semi limbs)."""
    from zerocaf_tpu_torch.ops import limb

    return tuple(limb.canonical(c, limb.FIELD) for c in point)


def muls(work) -> float:
    """Field multiplies that the 8 x 32 core's kernels run for ``work``
    (field multiplies, squares): the core squares by its multiply (the
    bound prices a square at the 76 word products it needs at least)."""
    return float(work[0]) + float(work[1])


def mul_latency_us(dev, rng) -> float:
    """The latency of one dependent field multiply of the core: zc_mul_chain
    (one thread, MUL_CHAIN multiplies, each of the last one's product) timed
    by CUDA events, after a warm-up launch whose product is held against
    the oracle (a b^n R^-n mod p)."""
    from zerocaf_tpu_torch import oracle as o
    from zerocaf_tpu_torch.ops.kernels import build

    R = 1 << 256
    a, b = (int.from_bytes(rng.bytes(32), "little") % o.P for _ in range(2))
    words = [(v >> (32 * i)) & 0xFFFFFFFF for v in (a, b) for i in range(8)]
    init = torch.tensor(np.array(words, np.uint32).view(np.int32), device=dev)
    x = init.clone()
    build.launch("zc_mul_chain", dev, "msm_kernels", "zc_mul_chain", x, MUL_CHAIN)
    got = sum(int(w) << (32 * i) for i, w in
              enumerate(x[:8].cpu().numpy().view(np.uint32)))
    if got != a * pow(b * pow(R, -1, o.P), MUL_CHAIN, o.P) % o.P:
        raise AssertionError("zc_mul_chain's product differs from the oracle's")
    x.copy_(init)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    build.launch("zc_mul_chain", dev, "msm_kernels", "zc_mul_chain", x, MUL_CHAIN)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / MUL_CHAIN


def k8_chain_rounds(nwin: int, nb: int, c: int, tail: int = 0) -> int:
    """Dependent multiply rounds on K8's critical path: two a point
    operation (csrc/quad32.cuh), over the nb - 1 additions of a window's
    running total and Horner's nwin (c + 1) operations and tail doublings
    (the quad's other rounds -- the conversion, d T -- not counted)."""
    return 2 * (nb - 1 + nwin * (c + 1) + tail)


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max().item())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device "
                         "(torch.cuda.is_available() is False)")
    import zerocaf_tpu_torch as zt
    from zerocaf_tpu_torch import constants as C
    from zerocaf_tpu_torch import oracle as o
    from zerocaf_tpu_torch.ops import limb
    from zerocaf_tpu_torch.ops.kernels import build
    from zerocaf_tpu_torch.ops.kernels import field_kernels as fk
    from zerocaf_tpu_torch.ops.kernels import msm_kernels as mk

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    roof = Roofline(sms, max_mhz)
    phase("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f" torch {torch.__version__} cuda {torch.version.cuda}, {sms} SMs, "
          f"max SM clock {max_mhz:.0f} MHz: {roof.imad_per_s / 1e12:.2f} T int32 "
          f"multiply-adds/s")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    paths, nvcc_s, log = build.build()
    for stem in paths:
        build.load(dev, stem)
    phase("build", f"{', '.join(p.name for p in paths.values())}: nvcc "
          f"{nvcc_s:.1f}s (all sources at once), ready in "
          f"{time.perf_counter() - t0:.1f}s")
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers",
                                   "spill stores", "bytes stack frame")):
            phase("ptxas", line.strip())
    report = ptxas_report(log)
    for kernel in CORE_KERNELS:
        stem = "msm_kernels" if kernel == "k_bucket_accum" else "field_kernels"
        for name, counts in sass_counts(paths[stem], kernel).items():
            r = report.get(name, {})
            was = UNTEMPLATED_SASS.get(name)
            phase("core kernels", f"{name}: {r.get('registers')} registers, "
                  f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} "
                  f"B spill loads, {r.get('stack')} B stack; SASS {counts[0]} "
                  f"IMAD.WIDE.U32 and {counts[1]} IMAD.HI of {counts[2]} "
                  f"instructions (at 4ba3dd9: {was}; "
                  f"{'the same' if was == counts else 'differs'})")
    for name, r in report.items():
        if any(k in name for k in PTXAS_KERNELS):
            phase("core kernels", f"{name}: {r.get('registers')} registers, "
                  f"{r.get('spill_stores')} B spill stores, {r.get('spill_loads')} "
                  f"B spill loads, {r.get('stack')} B stack")
    steps = {k: mul_step_instructions(paths["field_kernels"], k)
             for k in ("k_ladder", "k_padd")}
    phase("core kernels", f"one step of the rolled multiply: {steps['k_ladder']} "
          f"instructions in k_ladder, {steps['k_padd']} in k_padd (8 steps a "
          f"multiply)")
    phase("bound basis", f"a field multiply {OPS_8X32[0]} and a square "
          f"{OPS_8X32[1]} word products on the 8 x 32 core (22 x 12 algebra: "
          f"{OPS_22X12[0]} and {OPS_22X12[1]} multiply-adds)")
    mul_us = mul_latency_us(dev, rng)
    phase("core kernels", f"zc_mul_chain: one dependent multiply of the core "
          f"takes {mul_us:.4f} us ({MUL_CHAIN} in one thread, CUDA events, "
          f"product equal to the oracle's)")

    def rand_bytes(shape):
        return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def rand_elems(n, spec):
        return limb.canonical(limb.from_bytes(rand_bytes((n, 32)), spec), spec)

    # 3. kernels against their plain versions ------------------------------
    results = {}

    def record(wrapper, err, ms=None, plain_ms=None, bound=None, **extra):
        r = results.setdefault(wrapper.__name__, {
            "max_abs_err": 0, "ms": None, "plain_ms": None, "bound_ms": None,
            "bound_by": None, "library_ms": None, "bound_ms_22x12": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms
            r.update(bound)
        r.update(extra)

    for spec in (limb.FIELD, limb.SCALAR):
        a = rand_elems(MUL_LANES, spec)
        b = rand_elems(MUL_LANES, spec)
        a = limb.sub(fk.mul_tiled_ref(a, b, spec), a)    # semi, maybe negative
        err = max_abs_err(fk.mul_tiled(a, b, spec), fk.mul_tiled_ref(a, b, spec))
        ms = cuda_ms(lambda: fk.mul_tiled(a, b, spec), 50)
        plain = cuda_ms(lambda: fk.mul_tiled_ref(a, b, spec), 5)
        phase("K1 mul_tiled", f"{spec.name} {MUL_LANES} lanes: max_abs_err {err} "
              f"(tolerance {TOLERANCE}), kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if err > TOLERANCE:
            raise AssertionError(f"K1 differs from its plain version ({spec.name})")
        if spec is limb.FIELD:                      # the main path's modulus
            record(fk.mul_tiled, err, ms, plain,
                   roof(MUL_LANES * MUL, 3 * MUL_LANES * 22 * 4))
        else:
            record(fk.mul_tiled, err)

    x = limb.sub(fk.mul_tiled_ref(rand_elems(BATCH, limb.FIELD),
                                  rand_elems(BATCH, limb.FIELD)),
                 rand_elems(BATCH, limb.FIELD))
    xr = limb.sub(fk.mul_tiled_ref(rand_elems(BATCH, limb.SCALAR),
                                   rand_elems(BATCH, limb.SCALAR), limb.SCALAR),
                  rand_elems(BATCH, limb.SCALAR))

    def k2_bound(e, n):
        """K2's bound for n lanes: the table's 14 multiplies, 4 squares a
        digit after the first and a multiply a nonzero one; limbs read and
        written once."""
        digits = fk.pow_digits(e)
        per_lane = (14 * MUL + 4 * (len(digits) - 1) * SQ
                    + sum(1 for d in digits[1:] if d) * MUL)
        return roof(n * per_lane, 2 * n * 22 * 4 + 4 * len(digits))

    def k2_peak(a, e):
        """Bytes one K2 launch allocates at its peak (its output)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fk.pow_tiled(a, e)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        return peak

    for e, spec, a in [(e, limb.FIELD, x) for e in C.CHAIN_EXPONENTS] + [
            (C.R - 2, limb.SCALAR, xr)]:
        err = max_abs_err(fk.pow_tiled(a, e, spec),
                          limb.canonical(fk.pow_tiled_ref(a, e, spec), spec))
        msg = (f"e={hex(e)[:12]}.. mod {'r' if spec is limb.SCALAR else 'p'}, "
               f"{BATCH} lanes: max_abs_err {err} (tolerance {TOLERANCE}, "
               f"canonical limbs)")
        if err > TOLERANCE:
            raise AssertionError(f"K2 differs from its plain version: {msg}")
        if e == C.EXP_SQRT_RATIO:       # the exponent every encode/decode runs
            ms = cuda_ms(lambda: fk.pow_tiled(x, e), 10)
            plain = cuda_ms(lambda: fk.pow_tiled_ref(x, e), 2)
            bound = k2_bound(e, BATCH)
            # 2^20 lanes, Engine.msm's decode: x repeated, so each block of
            # 32768 lanes must equal the first call's result
            big = x.repeat(POW_BIG // BATCH, 1)
            out_big = fk.pow_tiled(big, e)
            if not torch.equal(out_big, fk.pow_tiled(x, e).repeat(POW_BIG // BATCH, 1)):
                raise AssertionError("K2 at 2^20 lanes differs from K2 at 32768")
            del out_big
            ms_big = cuda_ms(lambda: fk.pow_tiled(big, e), 3)
            bound_big = k2_bound(e, POW_BIG)
            peak, peak_big = k2_peak(x, e), k2_peak(big, e)
            del big
            msg += (f", kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                    f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}, peak "
                    f"{peak / 2**20:.1f} MiB; at {POW_BIG} lanes kernel "
                    f"{ms_big:.3f} ms, bound {bound_big['bound_ms']:.3f} ms by "
                    f"{bound_big['bound_by']}, peak {peak_big / 2**20:.1f} MiB")
            record(fk.pow_tiled, err, ms, plain, bound, ms_2p20=ms_big,
                   bound_ms_2p20=bound_big["bound_ms"], peak_bytes=peak,
                   peak_bytes_2p20=peak_big)
        else:
            record(fk.pow_tiled, err)
        phase("K2 pow_tiled", msg)

    # random points of the prime-order group, random canonical scalars
    pts = zt.RistrettoPoint.from_uniform_bytes(rand_bytes((BATCH, 64))).point._tuple()
    pts = tuple(c.contiguous() for c in pts)
    s = zt.Scalar.from_bytes_wide(rand_bytes((BATCH, 64)))
    # multiply-adds per lane: the Niels table, then per window the
    # doublings (T on the last) and one Niels addition
    k3_lane = MUL + 250 * (PDBL_T + MADD)
    k4_lane = 7 * PADD + 8 * MUL + 63 * (3 * PDBL + PDBL_T + MADD)
    ladder_cases = (
        (fk.scalar_mul_windowed_stepped, fk.scalar_mul_windowed_stepped_ref,
         s.into_bits(250), 1, "K3 ladder (width 1)", k3_lane),
        (fk.scalar_mul_windowed_signed, fk.scalar_mul_windowed_signed_ref,
         s.windows(4, 63), 4, "K4 signed windows (width 4)", k4_lane),
    )
    for wrapper, ref, win, width, label, per_lane in ladder_cases:
        got = wrapper(pts, win, width)
        want = canonical(ref(pts, win, width))
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: wrapper(pts, win, width), 3)
        plain = cuda_ms(lambda: ref(pts, win, width), 1)
        bound = roof(BATCH * per_lane, BATCH * (2 * PT_BYTES + 4 * win.shape[-1]))
        issue = mul_issue_ms(steps["k_ladder"], BATCH * muls(per_lane), sms,
                             max_mhz)
        phase(label, f"{BATCH} lanes: max_abs_err {err} (tolerance {TOLERANCE}, "
              f"canonical limbs), kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
              f"{bound['bound_ms']:.3f} ms by {bound['bound_by']}, its "
              f"multiplies at the issue rate {issue} ms")
        if err > TOLERANCE:
            raise AssertionError(f"{label} differs from its plain version")
        record(wrapper, err, ms, plain, bound)
    torch.cuda.synchronize()

    # 4. vectors -----------------------------------------------------------
    small = (zt.RistrettoPoint.basepoint((16,), dev)
             * zt.Scalar.from_int(list(range(16)), dev)).compress().cpu().numpy()
    for i, want in enumerate(SMALL_MULTIPLES):
        if small[i].tobytes().hex() != want:
            raise AssertionError(f"small multiple {i}: {small[i].tobytes().hex()}")
    if small[2].tobytes().hex() != TWO_B:
        raise AssertionError("[2]B")
    sage = zt.FieldElement.from_bytes(
        torch.tensor(list(bytes.fromhex(SAGE_INPUT)), dtype=torch.uint8, device=dev))
    sage_wire = zt.RistrettoPoint.elligator(sage).compress().cpu().numpy().tobytes()
    sx, sy, _, st = SAGE_POINT
    sage_want = o.ristretto_compress((o.limbs52_to_int(sx), o.limbs52_to_int(sy), 1,
                                      o.limbs52_to_int(st)))
    if sage_wire != sage_want:
        raise AssertionError("Elligator sage vector")
    torch.cuda.synchronize()
    phase("vectors", "16 Ristretto small multiples, [2]B and the Elligator sage "
          "vector byte-exact")

    # 5. ECDH at batch 32768 -------------------------------------------------
    seeds_a = rng.integers(0, 256, (BATCH, 64), dtype=np.uint8)
    seeds_b = rng.integers(0, 256, (BATCH, 64), dtype=np.uint8)
    uniform = rng.integers(0, 256, (BATCH, 64), dtype=np.uint8)
    eng = zt.Engine(batch=BATCH, device=dev)
    torch.cuda.synchronize()
    fk.reset_launch_counts()

    t_main = time.perf_counter()
    sa = zt.Scalar.from_bytes_wide(torch.as_tensor(seeds_a).to(dev))
    sb = zt.Scalar.from_bytes_wide(torch.as_tensor(seeds_b).to(dev))
    sk_a, sk_b = sa.to_bytes(), sb.to_bytes()
    pk_a = (zt.RistrettoPoint.basepoint((BATCH,), dev) * sa).compress()
    pk_b = (zt.RistrettoPoint.basepoint((BATCH,), dev) * sb).compress()
    s_ab, ok_ab = eng.dh(sk_a, pk_b)
    s_ba, ok_ba = eng.dh(sk_b, pk_a)
    bad = pk_b.clone()
    bad[1] = 0xFF                                   # non-canonical encoding
    _, ok_bad = eng.dh(sk_a, bad)
    # 6. hash_to_group
    h2g = eng.hash_to_group(torch.as_tensor(uniform))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    counts = {k: v for k, v in fk.launch_counts().items() if k in ECDH_KERNELS}

    if not (bool(ok_ab.all()) and bool(ok_ba.all())):
        raise AssertionError("dh rejected a valid peer key")
    if not torch.equal(s_ab, s_ba):
        raise AssertionError("the two sides' shared secrets differ")
    ok_bad = ok_bad.cpu().numpy()
    if ok_bad[1] or not ok_bad[0] or not ok_bad[2:].all():
        raise AssertionError(f"invalid peer lane not rejected alone: {ok_bad[:4]}")
    lanes = rng.choice(BATCH, SAMPLE, replace=False)
    sk_a_np, pk_a_np, s_np = sk_a.cpu().numpy(), pk_a.cpu().numpy(), s_ab.cpu().numpy()
    h2g_np = h2g.cpu().numpy()
    for i in lanes:
        ka = int.from_bytes(seeds_a[i].tobytes(), "little") % o.R
        kb = int.from_bytes(seeds_b[i].tobytes(), "little") % o.R
        if sk_a_np[i].tobytes() != ka.to_bytes(32, "little"):
            raise AssertionError(f"lane {i}: secret key bytes")
        if pk_a_np[i].tobytes() != o.ristretto_compress(o.scalar_mul(o.BASEPOINT, ka)):
            raise AssertionError(f"lane {i}: public key")
        if s_np[i].tobytes() != o.ristretto_compress(
                o.scalar_mul(o.BASEPOINT, ka * kb % o.R)):
            raise AssertionError(f"lane {i}: shared secret")
        if h2g_np[i].tobytes() != o.ristretto_compress(
                o.from_uniform_bytes(uniform[i].tobytes())):
            raise AssertionError(f"lane {i}: hash_to_group")
    phase("ecdh", f"batch {BATCH}: all ok, both sides equal on every lane, "
          f"{SAMPLE} sampled lanes equal the oracle, invalid lane rejected")
    phase("hash_to_group", f"batch {BATCH}: {SAMPLE} sampled lanes equal the oracle")

    # 7. launch counts -------------------------------------------------------
    phase("launches", f"main path ({main_s:.2f}s host): {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # 8. rates ---------------------------------------------------------------
    rates = []
    for name, fn in (("dh", lambda: eng.dh(sk_a, pk_b)),
                     ("hash_to_group",
                      lambda: eng.hash_to_group(torch.as_tensor(uniform)))):
        t = call_ms(fn, RATE_CALLS)
        med = t[len(t) // 2]
        rates.append(f"{name} {BATCH / med * 1e3:.0f} ops/s (median {med:.2f} ms, "
                     f"min {t[0]:.2f}, max {t[-1]:.2f} over {len(t)} calls)")
    k3_ms = results["scalar_mul_windowed_stepped"]["ms"]
    k4_ms = results["scalar_mul_windowed_signed"]["ms"]
    phase("rates", f"{card}: {', '.join(rates)}, ladder {BATCH / k3_ms * 1e3:.0f} "
          f"mults/s, signed windowed {BATCH / k4_ms * 1e3:.0f} mults/s, batch {BATCH}")

    msm_main, msm_ctx = msm_phases(dev, rng, roof, card, pts, record, steps,
                                   mul_us)
    counts.update(msm_main)
    counts.update(keygen_phases(dev, rng, roof, card, pts, s, record, steps))
    counts.update(msm_option_phases(dev, roof, card, msm_ctx, record))
    counts.update(sharded_phases(dev, card, msm_ctx))
    checkpoint_phase(dev, msm_ctx)

    replaces = {"mul_tiled": (SOURCE, TPU_KERNELS, 1133),
                "pow_tiled": (SOURCE, TPU_KERNELS, 1030),
                "scalar_mul_windowed_stepped": (SOURCE, TPU_KERNELS, 704),
                "scalar_mul_windowed_signed": (SOURCE, TPU_KERNELS, 825),
                "padd_tiled": (SOURCE, TPU_KERNELS, 313),
                "fixed_base_mul_stepped": (SOURCE, TPU_KERNELS, 437),
                "scalar_mul_windowed_fused": (SOURCE, TPU_KERNELS, 909),
                "bucket_accum_all": (MSM_SOURCE, TPU_MSM_KERNELS, 392),
                "to_field32": (MSM_SOURCE, TPU_MSM_KERNELS, 392),
                "combine_tables": (MSM_SOURCE, TPU_MSM_KERNELS, 247),
                "bucket_accum_k": (MSM_SOURCE, TPU_MSM_KERNELS, 339),
                "bucket_accum": (MSM_SOURCE, TPU_MSM_KERNELS, 141),
                "bucket_accum2": (MSM_SOURCE, TPU_MSM_KERNELS, 175)}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": f"{tpu}:{line}", "launches": counts[name],
                **results[name]} for name, (src, tpu, line) in replaces.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def msm_inputs(pt, scalars, c: int):
    """The dense route's K7 inputs for points pt and Scalars, as
    parallel/msm.py builds them: (stacked points, grouped digits, nb,
    lanes, nwin)."""
    import importlib

    from zerocaf_tpu_torch.ops.kernels import msm_kernels as mk

    tmsm = importlib.import_module("zerocaf_tpu_torch.parallel.msm")
    nwin = tmsm.nwin_for(c)
    dig = tmsm.dense_digits(scalars.windows(c, nwin), c, nwin)
    return (torch.stack(pt), dig, (1 << (c - 1)) + 1,
            mk.dense_lanes(dig.shape[-1]), nwin)


def msm_counts(fk, mk) -> dict[str, int]:
    """The launch counts of K5, K7 and K8."""
    return {k: v for k, v in {**fk.launch_counts(), **mk.launch_counts()}.items()
            if k in MSM_KERNELS}


def padd_ref_rows(fk, a, b, rows: int = 256):
    """K5's plain version on [E, W, 22] operands, ``rows`` of E at a time:
    its [.., 22, 22] products of all lanes at once would not fit the card."""
    parts = [fk.padd_tiled_ref(tuple(c[i:i + rows] for c in a),
                               tuple(c[i:i + rows] for c in b))
             for i in range(0, a[0].shape[0], rows)]
    return tuple(torch.cat(cs) for cs in zip(*parts))


def k7_work(dig_g, nb: int, lanes: int) -> tuple[float, float]:
    """(multiply-adds, bytes) of K7 on these digits: one padd_ext per
    nonzero digit; points and digits read once, tables written once."""
    ngrp, k, n = dig_g.shape
    nonzero = int((dig_g != 0).sum().item())
    return (nonzero * PADD,
            n * PT_BYTES + 4 * dig_g.numel() + ngrp * k * nb * lanes * PT_BYTES)


def k8_work(nwin: int, nb: int, c: int, tail: int = 0) -> tuple[float, float]:
    """(multiply-adds, bytes) of K8: 2(nb-1) additions per window, then per
    window c doublings and one addition, then tail doublings."""
    work = nwin * (2 * (nb - 1) * PADD + (c - 1) * PDBL + PDBL_T + PADD)
    if tail:
        work = work + (tail - 1) * PDBL + PDBL_T
    return work, nwin * nb * PT_BYTES + PT_BYTES


def msm_phases(dev, rng, roof, card, ecdh_pts, record, steps,
               mul_us) -> dict[str, int]:
    """Phases 9-15: K5, K7 and K8 against their plain versions, Engine.msm
    at 2^20 against the oracle, the route cross-check, the rates and the
    profile.  Returns the launch counts of K5, K7 and K8 in the three
    Engine.msm calls of phase 11, the MSM main path.  steps: phase 2's
    instructions in a step of the rolled multiply, by kernel; mul_us: its
    latency of one dependent multiply."""
    import importlib

    import zerocaf_tpu_torch as zt
    from zerocaf_tpu_torch import oracle as o
    from zerocaf_tpu_torch.models import ristretto as ri
    from zerocaf_tpu_torch.ops.kernels import field_kernels as fk
    from zerocaf_tpu_torch.ops.kernels import msm_kernels as mk

    tmsm = importlib.import_module("zerocaf_tpu_torch.parallel.msm")

    # 9. K5 at 2^16 lanes: group points, half of them negated (signed limbs)
    p = tuple(torch.cat([c, c]) for c in ecdh_pts)
    q = tuple(torch.roll(c, 1, 0) for c in p)
    p = (torch.cat([-p[0][:BATCH], p[0][BATCH:]]), p[1], p[2],
         torch.cat([-p[3][:BATCH], p[3][BATCH:]]))
    err = max_abs_err(fk.padd_tiled(p, q), canonical(fk.padd_tiled_ref(p, q)))
    ms = cuda_ms(lambda: fk.padd_tiled(p, q), 20)
    plain = cuda_ms(lambda: fk.padd_tiled_ref(p, q), 3)
    phase("K5 padd_tiled", f"{MUL_LANES} lanes: max_abs_err {err} (tolerance "
          f"{TOLERANCE}, canonical limbs), kernel {ms:.4f} ms, plain {plain:.4f} ms")
    if err > TOLERANCE:
        raise AssertionError("K5 differs from its plain version")
    record(fk.padd_tiled, err)           # timed at the main path's shape below

    # the MSM inputs: k'_i from seeded bytes, P_i = k'_i B by the ladder
    seeds_k = rng.integers(0, 256, (MSM_BATCH, 64), dtype=np.uint8)
    seeds_s = rng.integers(0, 256, (MSM_BATCH, 64), dtype=np.uint8)
    t0 = time.perf_counter()
    kp = zt.Scalar.from_bytes_wide(torch.as_tensor(seeds_k).to(dev))
    pts = (zt.EdwardsPoint.basepoint((MSM_BATCH,), dev) * kp)._tuple()
    wire = ri._compress(pts)
    sc = zt.Scalar.from_bytes_wide(torch.as_tensor(seeds_s).to(dev)).to_bytes()
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    k_int = [int.from_bytes(r.tobytes(), "little") % o.R for r in seeds_k]
    s_int = [int.from_bytes(r.tobytes(), "little") % o.R for r in seeds_s]
    if sc[7].cpu().numpy().tobytes() != s_int[7].to_bytes(32, "little"):
        raise AssertionError("scalar bytes")

    def oracle_wire(n):
        total = sum(a * b for a, b in zip(k_int[:n], s_int[:n])) % o.R
        return o.ristretto_compress(o.scalar_mul(o.BASEPOINT, total))

    phase("msm inputs", f"{MSM_BATCH} points k'B by the ladder and encoded, "
          f"{MSM_BATCH} scalars, in {make_s:.2f}s")

    # 10. K7 and K8 at 2^14 points, c = 6
    small = tuple(c[:MSM_SMALL].contiguous() for c in pts)
    s_small = zt.Scalar.from_bytes(sc[:MSM_SMALL])[0]
    pst, dig, nb, lanes, nwin = msm_inputs(small, s_small, MSM_C)
    errp = max_abs_err(mk.to_field32(pst), mk.to_field32_ref(pst))
    phase("to_field32", f"{MSM_SMALL} points: max_abs_err {errp} (tolerance "
          f"{TOLERANCE})")
    if errp > TOLERANCE:
        raise AssertionError("the prep kernel differs from its plain version")
    record(mk.to_field32, errp)
    tbl = mk.bucket_accum_all(pst, dig, nb, lanes)
    err7 = max_abs_err(tbl, mk.bucket_accum_all_ref(pst, dig, nb, lanes))
    ms7 = cuda_ms(lambda: mk.bucket_accum_all(pst, dig, nb, lanes), 5)
    plain7 = cuda_ms(lambda: mk.bucket_accum_all_ref(pst, dig, nb, lanes), 1)
    phase("K7 bucket_accum_all", f"{MSM_SMALL} points, c {MSM_C}, k "
          f"{tmsm.DENSE_K}, {lanes} lanes: max_abs_err {err7} (tolerance "
          f"{TOLERANCE}), kernel {ms7:.3f} ms, plain {plain7:.3f} ms")
    arr = tbl.view(-1, lanes, 4, 22)
    red = tmsm._lane_reduce(tuple(arr[:, :, j] for j in range(4)))
    tables = tuple(t.reshape(-1, nb, 22)[:nwin].contiguous() for t in red)
    if err7 > TOLERANCE:
        raise AssertionError("K7 differs from its plain version")
    record(mk.bucket_accum_all, err7)
    # K8 as Engine.msm runs it, then in the shape of rank 3 of 4 in the
    # window-sharded combine at c = 6 (parallel/msm.py:_sharded_combine):
    # 11 windows (here the first 11 tables), c ndev doublings a window, c
    # rank after them
    ndev, rank = 4, 3
    k = -(-nwin // ndev)
    strided = tuple(t[:k].contiguous() for t in tables)
    for label, tb, nw, c, tail in (("", tables, nwin, MSM_C, 0),
                                   (" strided", strided, k, MSM_C * ndev,
                                    MSM_C * rank)):
        err8 = max_abs_err(mk.combine_tables(tb, nb, nw, c, tail=tail),
                           canonical(mk.combine_tables_ref(tb, nb, nw, c, tail)))
        ms8 = cuda_ms(lambda: mk.combine_tables(tb, nb, nw, c, tail=tail), 5)
        plain8 = cuda_ms(lambda: mk.combine_tables_ref(tb, nb, nw, c, tail), 1)
        rounds = k8_chain_rounds(nw, nb, c, tail)
        chain = rounds * mul_us / 1e3
        bound = roof(*k8_work(nw, nb, c, tail))
        phase(f"K8 combine_tables{label}", f"nwin {nw}, nb {nb}, c {c}, tail "
              f"{tail}: max_abs_err {err8} (tolerance {TOLERANCE}, canonical "
              f"limbs), kernel {ms8:.4f} ms, plain {plain8:.1f} ms, bound "
              f"{bound['bound_ms']:.5f} ms by {bound['bound_by']}, chain bound "
              f"{chain:.4f} ms ({rounds} dependent multiply rounds of "
              f"{mul_us:.4f} us)")
        if err8 > TOLERANCE:
            raise AssertionError(f"K8{label} differs from its plain version")
        if tail:
            record(mk.combine_tables, err8, strided_ms=ms8, strided_plain_ms=plain8,
                   strided_chain_bound_ms=chain)
        else:
            record(mk.combine_tables, err8, ms8, plain8, bound, chain_bound_ms=chain,
                   chain_rounds=rounds, mul_latency_us=mul_us)
    torch.cuda.synchronize()

    # 11. Engine.msm at 2^20: the main path, with its own launch counts
    eng = zt.Engine(batch=MSM_BATCH, device=dev)
    bad = wire.clone()
    bad[3] = 0xFF                                   # non-canonical encoding
    n_pad = MSM_BATCH - 3
    p_pad, s_pad, n_valid = zt.pad_msm(wire[:n_pad].cpu().numpy(),
                                       sc[:n_pad].cpu().numpy(), MSM_BATCH)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    mk.reset_launch_counts()
    t_main = time.perf_counter()
    got, ok = eng.msm(wire, sc)
    _, ok_bad = eng.msm(bad, sc)
    got_pad, ok_pad = eng.msm(p_pad, s_pad)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    counts = msm_counts(fk, mk)

    if not bool(ok) or bool(ok_bad) or not bool(ok_pad) or n_valid != n_pad:
        raise AssertionError(f"msm ok flags: {bool(ok)}, invalid lane "
                             f"{bool(ok_bad)}, padded {bool(ok_pad)}")
    if got.cpu().numpy().tobytes() != oracle_wire(MSM_BATCH):
        raise AssertionError("Engine.msm at 2^20 differs from the oracle")
    if got_pad.cpu().numpy().tobytes() != oracle_wire(n_pad):
        raise AssertionError("pad_msm changed the sum")
    phase("msm", f"batch {MSM_BATCH}, c {MSM_C}: equals the oracle's aggregate; "
          f"invalid lane makes ok false; pad_msm of {n_pad} lanes equals their "
          f"MSM")
    phase("launches", f"msm main path, 3 Engine.msm calls ({main_s:.2f}s host): "
          f"{json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the msm path: {missing}")

    # 12. the route cross-check at 2^14, counted apart from the main path
    pts_small = zt.EdwardsPoint(*ri._decompress(wire[:MSM_SMALL])[0])
    fk.reset_launch_counts()
    mk.reset_launch_counts()
    scan = tmsm.msm(pts_small, s_small, dense=False)
    dense = tmsm.msm(pts_small, s_small, dense=True)
    scan_w, dense_w = ri._compress(scan._tuple()), ri._compress(dense._tuple())
    torch.cuda.synchronize()
    cross = msm_counts(fk, mk)
    if not (scan_w.cpu().numpy().tobytes() == dense_w.cpu().numpy().tobytes()
            == oracle_wire(MSM_SMALL)):
        raise AssertionError("scan and dense routes differ at 2^14")
    phase("msm routes", f"at {MSM_SMALL} points scan == dense == oracle; "
          f"launches {json.dumps(cross)}")

    # 13. at the shapes of the 2^20 path: K7, and K5 on the first round of
    # the lane reduction (the halves of K7's tables, read in place), against
    # their plain versions; K8's time
    pts_big = ri._decompress(wire)[0]
    s_big = zt.Scalar.from_bytes(sc)[0]
    pst, dig, nb, lanes, nwin = msm_inputs(pts_big, s_big, MSM_C)
    w32 = mk.to_field32(pst)
    errp = max_abs_err(w32, mk.to_field32_ref(pst))
    msp = cuda_ms(lambda: mk.to_field32(pst), 10)
    plainp = cuda_ms(lambda: mk.to_field32_ref(pst), 1)
    bp = roof(4 * pst.shape[1] * MUL, 4 * (pst.numel() + w32.numel()))
    phase("to_field32", f"{pst.shape[1]} points: max_abs_err {errp} (tolerance "
          f"{TOLERANCE}), kernel {msp:.4f} ms, plain {plainp:.3f} ms, bound "
          f"{bp['bound_ms']:.4f} ms by {bp['bound_by']}")
    if errp > TOLERANCE:
        raise AssertionError("the prep kernel differs from its plain version at 2^20")
    record(mk.to_field32, errp, msp, plainp, bp)
    del w32
    tbl = mk.bucket_accum_all(pst, dig, nb, lanes)
    t0 = time.perf_counter()
    ref = mk.bucket_accum_all_ref(pst, dig, nb, lanes)
    torch.cuda.synchronize()
    plain7 = (time.perf_counter() - t0) * 1e3
    err7 = max_abs_err(tbl, ref)
    del ref
    ms7 = cuda_ms(lambda: mk.bucket_accum_all(pst, dig, nb, lanes), 3)
    if err7 > TOLERANCE:
        raise AssertionError("K7 differs from its plain version at 2^20")
    b7 = roof(*k7_work(dig, nb, lanes))
    record(mk.bucket_accum_all, err7, ms7, plain7, b7)
    arr = tbl.view(-1, lanes, 4, 22)
    half = lanes // 2
    a = tuple(arr[:, :half, j] for j in range(4))
    b = tuple(arr[:, half:, j] for j in range(4))
    n5 = arr.shape[0] * half
    err5 = max_abs_err(fk.padd_tiled(a, b), canonical(padd_ref_rows(fk, a, b)))
    ms5 = cuda_ms(lambda: fk.padd_tiled(a, b), 3)
    plain5 = cuda_ms(lambda: padd_ref_rows(fk, a, b), 1)
    if err5 > TOLERANCE:
        raise AssertionError("K5 differs from its plain version on the first "
                             "lane-reduce round")
    b5 = roof(n5 * PADD, 3 * n5 * PT_BYTES)
    issue5 = mul_issue_ms(steps["k_padd"], n5 * muls(PADD + 2 * MUL), roof.sms,
                          roof.max_sm_mhz)
    record(fk.padd_tiled, err5, ms5, plain5, b5)
    # K5 on every round of the lane reduction (parallel/msm.py:_lane_reduce)
    v = tuple(arr[:, :, j] for j in range(4))
    rounds = []
    while v[0].shape[1] > 1:
        h = v[0].shape[1] // 2
        ra, rb = tuple(c[:, :h] for c in v), tuple(c[:, h:] for c in v)
        n_r = ra[0].shape[0] * h
        rounds.append((n_r, cuda_ms(lambda: fk.padd_tiled(ra, rb), 3),
                       roof(n_r * PADD, 3 * n_r * PT_BYTES)["bound_ms"]))
        v = fk.padd_tiled(ra, rb)
    cost5 = sum(ms - bnd for _, ms, bnd in rounds)
    record(fk.padd_tiled, 0, rounds_lanes=[r[0] for r in rounds],
           rounds_ms=[r[1] for r in rounds],
           rounds_bound_ms=[r[2] for r in rounds], cost_per_call=cost5)
    phase("K5 lane-reduce rounds", f"{len(rounds)} rounds of one Engine.msm call "
          f"at {MSM_BATCH}: " + ", ".join(f"{n_r} lanes {ms:.4f} ms (bound "
                                          f"{bnd:.4f})" for n_r, ms, bnd in rounds)
          + f"; total {sum(r[1] for r in rounds):.3f} ms, sum of (ms - bound) "
          f"{cost5:.3f}; the first round's 12 multiplies a lane at the issue "
          f"rate {issue5} ms")
    del v, ra, rb
    red = tmsm._lane_reduce(tuple(arr[:, :, j] for j in range(4)))
    tables = tuple(t.reshape(-1, nb, 22)[:nwin].contiguous() for t in red)
    ms8 = cuda_ms(lambda: mk.combine_tables(tables, nb, nwin, MSM_C), 5)
    phase("msm kernels at 2^20", f"K7 {ms7:.3f} ms (plain {plain7:.1f} ms, one "
          f"call; max_abs_err {err7}; bound {b7['bound_ms']:.3f} ms by "
          f"{b7['bound_by']}, 22 x 12 basis {b7['bound_ms_22x12']:.3f} ms), "
          f"{lanes} lanes x {dig.shape[0]} groups, tables "
          f"{tbl.numel() * 4 / 2**30:.2f} GiB; K5 first lane-reduce round "
          f"{n5} lanes {ms5:.3f} ms (plain {plain5:.1f} ms; max_abs_err {err5}; "
          f"bound {b5['bound_ms']:.3f} ms); K8 {ms8:.3f} ms")
    del tbl, arr, a, b, red

    # 14. rates
    rates = []
    for c in MSM_SWEEP:
        t = call_ms(lambda: eng.msm(wire, sc, c=c), MSM_RATE_CALLS)
        med = t[len(t) // 2]
        rates.append(f"c={c} {MSM_BATCH / med * 1e3:.0f} points/s (median "
                     f"{med:.1f} ms, min {t[0]:.1f}, max {t[-1]:.1f} over "
                     f"{len(t)} calls)")
    phase("msm rates", f"{card}: Engine.msm at batch {MSM_BATCH}: "
          f"{'; '.join(rates)}; peak memory allocated in this run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    profile_call("msm profile", f"one Engine.msm call at {MSM_BATCH}, c {MSM_C}",
                 lambda: eng.msm(wire, sc))
    profile_copies("msm copies", lambda: eng.msm(wire, sc))
    return counts, dict(wire=wire, sc=sc, engine=got.cpu().numpy().tobytes(),
                        oracle_wire=oracle_wire)


def keygen_phases(dev, rng, roof, card, pts, s, record, steps) -> dict[str, int]:
    """Phases 16-20: the comb table, K6 against its plain version,
    Engine.keygen at batch 32768 against the ladder and the oracle, K10,
    and the keygen rate.  pts and s are phase 3's random points and
    scalars, steps phase 2's multiply steps.  Returns the launches of K6 in the
    keygen call (the keygen main path) and of K10 in its own call."""
    import zerocaf_tpu_torch as zt
    from zerocaf_tpu_torch import oracle as o
    from zerocaf_tpu_torch.models import edwards as ed
    from zerocaf_tpu_torch.models import ristretto as ri
    from zerocaf_tpu_torch.ops.kernels import field_kernels as fk

    # 16. the comb table
    sw = ed.COMB_WIDTH_SIGNED
    cached = ed.comb_cache_path(sw, True).exists()
    t0 = time.perf_counter()
    host = ed._fixed_base_table_signed(sw)
    built_s = time.perf_counter() - t0
    dev_tbl = {layout: ed.comb_table(sw, True, layout, dev)
               for layout in ("packed", "rows")}
    torch.cuda.synchronize()
    phase("comb table", f"signed width {sw}: {list(host.shape)} int32 "
          f"({host.nbytes / 1e6:.1f} MB) from the {'cache' if cached else 'oracle'} "
          f"in {built_s:.2f}s; on the card packed {dev_tbl['packed'].nbytes / 1e6:.1f}"
          f" MB, rows {dev_tbl['rows'].nbytes / 1e6:.1f} MB")

    # 17. K6 against its plain version at BATCH lanes
    cases = ((sw, True, "packed2"), (sw, True, "rows"), (8, False, "rows"))
    for width, signed, glue in cases:
        win = s.windows(width, -(-250 // width))
        got = fk.fixed_base_mul_stepped(win, width, signed=signed, glue=glue)
        want = fk.fixed_base_mul_stepped_ref(win, width, signed=signed, glue=glue)
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: fk.fixed_base_mul_stepped(win, width, signed=signed,
                                                       glue=glue), 20)
        plain = cuda_ms(lambda: fk.fixed_base_mul_stepped_ref(
            win, width, signed=signed, glue=glue), 1)
        tbl = ed.comb_table(width, signed, fk.comb_layout(glue), dev)
        bound = roof(BATCH * win.shape[-1] * MADD7,
                     tbl.nbytes + win.nbytes + BATCH * PT_BYTES)
        label = f"{'signed' if signed else 'unsigned'} width {width} {glue}"
        phase("K6 fixed_base_mul_stepped", f"{label}, {BATCH} lanes: max_abs_err "
              f"{err} (tolerance {TOLERANCE}), kernel {ms:.4f} ms, plain "
              f"{plain:.2f} ms, bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}")
        if err > TOLERANCE:
            raise AssertionError(f"K6 differs from its plain version ({label})")
        if glue == "packed2":                  # basepoint_mul's route
            k6_ms = ms
            record(fk.fixed_base_mul_stepped, err, ms, plain, bound)
        else:
            record(fk.fixed_base_mul_stepped, err)

    # 18. Engine.keygen at BATCH: the keygen main path
    seeds = rng.integers(0, 256, (BATCH, 64), dtype=np.uint8)
    special = [2**250 - o.R, 0, 1, o.R - 1]
    for i, k in enumerate(special):         # bytes of k, then 32 zero bytes
        seeds[i] = np.frombuffer(k.to_bytes(32, "little") + bytes(32), np.uint8)
    seeds_t = torch.as_tensor(seeds)
    eng = zt.Engine(batch=BATCH, device=dev)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    sk, pk = eng.keygen(seeds_t)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = {k: v for k, v in fk.launch_counts().items() if k in KEYGEN_KERNELS}

    ladder = (zt.RistrettoPoint.basepoint((BATCH,), dev)
              * zt.Scalar.from_bytes(sk)[0]).compress()
    if not torch.equal(pk, ladder):
        bad = int((pk != ladder).any(-1).sum().item())
        raise AssertionError(f"keygen pk differs from the ladder's on {bad} lanes")
    sk_np, pk_np = sk.cpu().numpy(), pk.cpu().numpy()
    lanes = list(range(len(special))) + list(rng.choice(
        np.arange(len(special), BATCH), SAMPLE, replace=False))
    for i in lanes:
        k = int.from_bytes(seeds[i].tobytes(), "little") % o.R
        if sk_np[i].tobytes() != k.to_bytes(32, "little"):
            raise AssertionError(f"keygen lane {i}: secret key bytes")
        if pk_np[i].tobytes() != o.ristretto_compress(o.scalar_mul(o.BASEPOINT, k)):
            raise AssertionError(f"keygen lane {i}: public key")
    phase("keygen", f"batch {BATCH}, comb width {sw}: pk equals the ladder's on "
          f"every lane; {SAMPLE} sampled lanes and k = 2^250 - r, 0, 1, r - 1 "
          f"equal the oracle")
    phase("launches", f"keygen main path, one Engine.keygen call ({main_s:.2f}s "
          f"host, first call): {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the keygen path: {missing}")

    # 19. K10 at BATCH lanes, width 4: its own entry's launch
    win4 = s.windows(4, 63)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    got = fk.scalar_mul_windowed_fused(pts, win4, 4)
    torch.cuda.synchronize()
    k10 = fk.scalar_mul_windowed_fused.launches
    err = max_abs_err(got, canonical(fk.scalar_mul_windowed_stepped_ref(pts, win4, 4)))
    same_k4 = torch.equal(ri._compress(got),
                          ri._compress(fk.scalar_mul_windowed_signed(pts, win4, 4)))
    ms = cuda_ms(lambda: fk.scalar_mul_windowed_fused(pts, win4, 4), 3)
    plain = cuda_ms(lambda: fk.scalar_mul_windowed_stepped_ref(pts, win4, 4), 1)
    k10_lane = 14 * PADD + 15 * MUL + 63 * (3 * PDBL + PDBL_T + MADD)
    bound = roof(BATCH * k10_lane, BATCH * (2 * PT_BYTES + 4 * 63))
    issue = mul_issue_ms(steps["k_ladder"], BATCH * muls(k10_lane), roof.sms,
                         roof.max_sm_mhz)
    phase("K10 scalar_mul_windowed_fused", f"width 4, {BATCH} lanes: {k10} launch, "
          f"max_abs_err {err} (tolerance {TOLERANCE}, canonical limbs), equal to "
          f"K4 after encoding: {same_k4}, kernel {ms:.3f} ms, plain {plain:.1f} ms, "
          f"bound {bound['bound_ms']:.3f} ms by {bound['bound_by']}, its "
          f"multiplies at the issue rate {issue} ms")
    if err > TOLERANCE or not same_k4 or k10 != 1:
        raise AssertionError("K10 differs from its plain version or from K4")
    record(fk.scalar_mul_windowed_fused, err, ms, plain, bound)

    # 20. keygen rate
    t = call_ms(lambda: eng.keygen(seeds_t), RATE_CALLS)
    med = t[len(t) // 2]
    phase("rates", f"{card}: keygen {BATCH / med * 1e3:.0f} ops/s (median "
          f"{med:.2f} ms, min {t[0]:.2f}, max {t[-1]:.2f} over {len(t)} calls), "
          f"batch {BATCH}; K6 alone {BATCH / k6_ms * 1e3:.0f} mults/s")
    profile_call("keygen profile", f"one Engine.keygen call at {BATCH}",
                 lambda: eng.keygen(seeds_t))
    return {"fixed_base_mul_stepped": counts["fixed_base_mul_stepped"],
            "scalar_mul_windowed_fused": k10}


def option_counts() -> dict[str, int]:
    """The launch counts of every MSM kernel: K5, K7, K8, K9, K11, K12."""
    from zerocaf_tpu_torch.ops.kernels import field_kernels as fk
    from zerocaf_tpu_torch.ops.kernels import msm_kernels as mk

    return {"padd_tiled": fk.padd_tiled.launches, **mk.launch_counts()}


def reset_counts() -> None:
    from zerocaf_tpu_torch.ops.kernels import field_kernels as fk
    from zerocaf_tpu_torch.ops.kernels import msm_kernels as mk

    torch.cuda.synchronize()
    fk.reset_launch_counts()
    mk.reset_launch_counts()


def host_ms(fn):
    """(result, host ms) of one call ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def msm_option_phases(dev, roof, card, ctx, record) -> dict[str, int]:
    """Phases 21-22: K9, K11 and K12 (K7's kernel for one window group)
    against their plain versions, with and without the fold; then every
    option of _msm_dense at 2^20 points against the oracle, each call with
    its own launch counts.  Returns the launches of K11 and K12 in the
    k = 1 and k = 2 calls, their main path."""
    import importlib

    import zerocaf_tpu_torch as zt
    from zerocaf_tpu_torch.models import ristretto as ri
    from zerocaf_tpu_torch.ops import limb
    from zerocaf_tpu_torch.ops.kernels import msm_kernels as mk

    tmsm = importlib.import_module("zerocaf_tpu_torch.parallel.msm")
    wire, sc = ctx["wire"], ctx["sc"]

    # 21. the group entries at 2^12 points, then at the 2^20 path's shapes
    entries = (("K9 bucket_accum_k", mk.bucket_accum_k, mk.bucket_accum_k_ref,
                tmsm.DENSE_K, lambda d: d[0], (0, FOLD_CHECKED)),
               ("K11 bucket_accum", mk.bucket_accum, mk.bucket_accum_ref, 1,
                lambda d: d[0, :1].contiguous(), (0,)),
               ("K12 bucket_accum2", mk.bucket_accum2, mk.bucket_accum2_ref, 2,
                lambda d: d[0, :2].contiguous(), (0,)))

    def call(fn, pst, d, nb, k, lanes, fold):
        if fn in (mk.bucket_accum_k, mk.bucket_accum_k_ref):
            return fn(pst, d, nb, k, lanes, fold)
        return fn(pst, d, nb, lanes)

    for n in (MSM_CHECK, MSM_BATCH):
        pts_n = ri._decompress(wire[:n])[0]
        pst, dig, nb, dense, _ = msm_inputs(pts_n, zt.Scalar.from_bytes(sc[:n])[0],
                                            MSM_C)
        for label, fn, ref, k, pick, folds in entries:
            d = pick(dig)
            # the lanes each entry's wrapper picks on the MSM path
            lanes = mk.wide_lanes(n, 1, dev) if k == 1 else dense
            for fold in folds:
                got = call(fn, pst, d, nb, k, lanes, fold)
                want, plain = host_ms(lambda: call(ref, pst, d, nb, k, lanes, fold))
                if fold:                       # K5's rounds: canonical limbs
                    want = limb.canonical(want, limb.FIELD)
                err = max_abs_err(got, want)
                del got, want
                msg = (f"{n} points, c {MSM_C}, k {k}, {lanes} lanes, fold {fold}: "
                       f"max_abs_err {err} (tolerance {TOLERANCE})")
                if err > TOLERANCE:
                    raise AssertionError(f"{label} differs from its plain version: {msg}")
                if n == MSM_BATCH:
                    ms = cuda_ms(lambda: call(fn, pst, d, nb, k, lanes, fold), 3)
                    bound = roof(*k7_work(d.view(1, k, -1), nb, lanes))
                    msg += (f", kernel {ms:.3f} ms, plain {plain:.1f} ms (one call), "
                            f"bound {bound['bound_ms']:.3f} ms by {bound['bound_by']} "
                            f"(22 x 12 basis {bound['bound_ms_22x12']:.3f} ms)")
                    if k < 3:
                        msg += lane_cost(fn, pst, d, nb, dense)
                    if fold == 0:
                        record(fn, err, ms, plain, bound)
                    else:
                        record(fn, err)
                else:
                    record(fn, err)
                phase(label, msg)
        # K7's fold, checked at 2^12 and timed at 2^20 (its plain version
        # there is phase 13's ten seconds again)
        if n == MSM_CHECK:
            err = max_abs_err(mk.bucket_accum_all(pst, dig, nb, lanes, FOLD_CHECKED),
                              limb.canonical(mk.bucket_accum_all_ref(
                                  pst, dig, nb, lanes, FOLD_CHECKED), limb.FIELD))
            phase("K7 bucket_accum_all", f"{n} points, fold {FOLD_CHECKED}: "
                  f"max_abs_err {err} (tolerance {TOLERANCE})")
            if err > TOLERANCE:
                raise AssertionError("K7 with fold differs from its plain version")
            record(mk.bucket_accum_all, err)
        else:
            ms = cuda_ms(lambda: mk.bucket_accum_all(pst, dig, nb, lanes,
                                                     FOLD_CHECKED), 3)
            phase("K7 bucket_accum_all", f"{n} points, fold {FOLD_CHECKED}: "
                  f"{ms:.3f} ms (K7 and {FOLD_CHECKED} K5 rounds over its tables)")
        del pst, dig
    torch.cuda.synchronize()

    # 22. the options of _msm_dense at 2^20, each against the oracle
    pts = ri._decompress(wire)[0]
    nwin = tmsm.nwin_for(MSM_C)
    win = zt.Scalar.from_bytes(sc)[0].windows(MSM_C, nwin)
    want = ctx["oracle_wire"](MSM_BATCH)
    options = (("k=1", dict(k=1), "bucket_accum"),
               ("k=2", dict(k=2), "bucket_accum2"),
               ("k=4, single_call=False", dict(k=4, single_call=False), "bucket_accum_k"),
               (f"fold={FOLD_CHECKED}", dict(fold=FOLD_CHECKED), "bucket_accum_all"),
               ("fused_combine=False", dict(fused_combine=False), "bucket_accum_all"))
    counts = {}
    for label, kw, entry in options:
        reset_counts()
        total, ms = host_ms(lambda: tmsm._msm_dense(pts, win, MSM_C, nwin, **kw))
        launched = {k: v for k, v in option_counts().items() if v}
        ok = ri._compress(total).cpu().numpy().tobytes() == want
        phase("msm dense options", f"{label}: {ms:.1f} ms (one call, {card}), "
              f"equals the oracle's aggregate: {ok}; launches {json.dumps(launched)}")
        needed = {entry, "to_field32", "padd_tiled"} | ({"combine_tables"} if kw.get(
            "fused_combine", True) else set())
        if not ok or needed - set(launched):
            raise AssertionError(f"_msm_dense({label}) at 2^20: wrong sum or "
                                 f"kernels not launched: {needed - set(launched)}")
        if entry in ("bucket_accum", "bucket_accum2"):
            counts[entry] = launched[entry]
    return counts


def lane_cost(fn, pst, d, nb: int, dense: int) -> str:
    """What the lanes of K11 or K12 cost: the kernel and its lane reduction
    (parallel/msm.py:_lane_tables, K5 rounds), CUDA-event means, at the
    lanes of one wave (wide_lanes), of two full waves (at least 8 points a
    lane) and at ``dense`` (dense_lanes) lanes."""
    import importlib

    from zerocaf_tpu_torch.ops.kernels import msm_kernels as mk

    tmsm = importlib.import_module("zerocaf_tpu_torch.parallel.msm")
    k, n = d.shape
    one_wave = mk.wide_lanes(n, k, pst.device)
    two_waves = min(1 << round(np.log2(2 * mk.wave_threads(pst.device) / k)),
                    1 << ((n >> 3).bit_length() - 1))
    parts = []
    for n_lanes in (one_wave, two_waves, dense):
        tbl = fn(pst, d, nb, n_lanes)
        k_ms = cuda_ms(lambda: fn(pst, d, nb, n_lanes), 3)
        r_ms = cuda_ms(lambda: tmsm._lane_tables(tbl), 3)
        parts.append(f"{n_lanes} lanes: kernel {k_ms:.3f} + lane reduction "
                     f"{r_ms:.3f} ms")
        del tbl
    return "; " + ", against ".join(parts)


def sharded_phases(dev, card, ctx) -> dict[str, int]:
    """Phases 23-24: msm_sharded at 2^20 points on one rank over NCCL
    (dense, shard_combine: the pod configuration; then dense alone), and on
    4 gloo ranks sharing the card, 2^18 points each.  Returns the launches
    of K9 in the 1-rank pod call, its main path."""
    import socket
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    import zerocaf_tpu_torch as zt
    from zerocaf_tpu_torch.config import MeshConfig
    from zerocaf_tpu_torch.models import ristretto as ri
    from zerocaf_tpu_torch.parallel import (batch_sharding, make_mesh,
                                            msm_sharded)

    wire, sc = ctx["wire"], ctx["sc"]
    want = ctx["oracle_wire"](MSM_BATCH)

    def free_port():
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            return sk.getsockname()[1]

    # 23. one rank over NCCL on cuda:0
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshConfig(n_devices=1), devices=dev)
        shard = batch_sharding(mesh)
        pts = zt.EdwardsPoint(*ri._decompress(shard(wire))[0])
        s = zt.Scalar.from_bytes(shard(sc))[0]
        pod = dict(c=MSM_C, dense=True, shard_combine=True)
        reset_counts()
        total, first_ms = host_ms(lambda: msm_sharded(pts, s, mesh, **pod))
        launched = option_counts()
        got = ri._compress(total._tuple()).cpu().numpy().tobytes()
        ngrp = -(-MSM_NWIN // 4)
        if got != want or got != ctx["engine"]:
            raise AssertionError("msm_sharded (1 rank, pod) differs from the "
                                 "oracle or Engine.msm")
        if (launched["bucket_accum_k"] != ngrp or launched["bucket_accum_all"]
                or launched["combine_tables"] != 1 or not launched["padd_tiled"]
                or not launched["to_field32"]):
            raise AssertionError(f"msm_sharded (1 rank, pod) launches: {launched}")
        t = call_ms(lambda: msm_sharded(pts, s, mesh, **pod), MSM_RATE_CALLS)
        phase("msm_sharded 1 rank", f"{MSM_BATCH} points, NCCL on {mesh.device}, "
              f"dense + shard_combine, c {MSM_C}: equals the oracle and "
              f"Engine.msm; launches {json.dumps(launched)}; {card}: median "
              f"{t[len(t) // 2]:.1f} ms (min {t[0]:.1f}, max {t[-1]:.1f} over "
              f"{len(t)} calls; first call {first_ms:.1f} ms)")
        k9 = launched["bucket_accum_k"]
        profile_call("msm_sharded profile", f"one 1-rank pod call at {MSM_BATCH}",
                     lambda: msm_sharded(pts, s, mesh, **pod))
        reset_counts()
        total, ms = host_ms(lambda: msm_sharded(pts, s, mesh, c=MSM_C, dense=True))
        launched = {k: v for k, v in option_counts().items() if v}
        if ri._compress(total._tuple()).cpu().numpy().tobytes() != want or (
                launched.get("bucket_accum_all") != 1
                or launched.get("combine_tables") != 1):
            raise AssertionError(f"msm_sharded (1 rank, dense): {launched}")
        phase("msm_sharded 1 rank", f"dense without shard_combine: equals the "
              f"oracle, {ms:.1f} ms (one call), launches {json.dumps(launched)}")
        del pts, s, total
    finally:
        dist.destroy_process_group()

    # 24. four gloo ranks sharing cuda:0, 2^18 points each
    world = 4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        np.save(f"{tmpdir}/wire.npy", wire.cpu().numpy())
        np.save(f"{tmpdir}/sc.npy", sc.cpu().numpy())
        os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        os.environ["MASTER_ADDR"] = "localhost"
        os.environ["MASTER_PORT"] = str(free_port())
        t0 = time.perf_counter()
        mp.spawn(gloo_rank, args=(world, str(dev), tmpdir, want.hex()),
                 nprocs=world, join=True)
        wall = time.perf_counter() - t0
        with open(f"{tmpdir}/ranks.json") as f:
            ranks = json.load(f)
    ngrp = -(-MSM_NWIN // 4)
    for r in ranks:
        phase("msm_sharded 4 ranks", f"rank {r['rank']}: {MSM_BATCH // world} "
              f"points on {r['device']}, equals the oracle: {r['ok']}; launches "
              f"{json.dumps(r['launches'])}; calls {r['ms']} ms; peak memory "
              f"{r['peak_bytes'] / 2**30:.2f} GiB")
        if (not r["ok"] or r["launches"]["bucket_accum_k"] != ngrp
                or r["launches"].get("combine_tables") != 1):
            raise AssertionError(f"msm_sharded on 4 ranks, rank {r['rank']}")
    phase("msm_sharded 4 ranks", f"gloo, {world} processes sharing the card "
          f"({card}), dense + shard_combine, c=None: every rank's total equals "
          f"the oracle's aggregate; {wall:.1f}s from spawn to join")
    return {"bucket_accum_k": k9}


def gloo_rank(rank: int, world: int, device: str, tmpdir: str,
              want_hex: str) -> None:
    """One of phase 24's ranks (a spawned process): its block of the 2^20
    points, msm_sharded on the parent's card (with the kernels the parent
    built), and its
    launches, times and peak memory, gathered to rank 0, which writes
    them for the parent."""
    import torch.distributed as dist

    import zerocaf_tpu_torch as zt
    from zerocaf_tpu_torch.config import MeshConfig
    from zerocaf_tpu_torch.models import ristretto as ri
    from zerocaf_tpu_torch.parallel import (batch_sharding,
                                            initialize_distributed, make_mesh,
                                            msm_sharded)

    initialize_distributed(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                           world, rank, backend="gloo")
    try:
        mesh = make_mesh(MeshConfig(n_devices=world), devices=device)
        shard = batch_sharding(mesh)
        pts = zt.EdwardsPoint(*ri._decompress(
            shard(torch.from_numpy(np.load(f"{tmpdir}/wire.npy"))))[0])
        s = zt.Scalar.from_bytes(shard(torch.from_numpy(np.load(f"{tmpdir}/sc.npy"))))[0]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        dist.barrier()
        pod = dict(dense=True, shard_combine=True)
        total, first = host_ms(lambda: msm_sharded(pts, s, mesh, **pod))
        launches = option_counts()
        times = [first]
        for _ in range(2):
            dist.barrier()
            times.append(host_ms(lambda: msm_sharded(pts, s, mesh, **pod))[1])
        got = ri._compress(total._tuple()).cpu().numpy().tobytes().hex()
        mine = {"rank": rank, "device": str(mesh.device), "ok": got == want_hex,
                "launches": {k: v for k, v in launches.items() if v},
                "ms": [round(t, 1) for t in times],
                "peak_bytes": torch.cuda.max_memory_allocated()}
        gathered = [None] * world if rank == 0 else None
        dist.gather_object(mine, gathered, dst=0)
        if rank == 0:
            with open(f"{tmpdir}/ranks.json", "w") as f:
                json.dump(gathered, f)
    finally:
        dist.destroy_process_group()


def checkpoint_phase(dev, ctx) -> None:
    """Phase 25: msm_with_checkpoints at 2^16 points in 4 blocks, and the
    same job stopped after block 2 and resumed from its file, against the
    one-shot MSM and the oracle."""
    import tempfile

    import zerocaf_tpu_torch as zt
    from zerocaf_tpu_torch.models import ristretto as ri
    from zerocaf_tpu_torch.parallel import checkpoint, msm

    n, block = CKPT_BATCH, CKPT_BATCH // 4
    pts = zt.EdwardsPoint(*ri._decompress(ctx["wire"][:n])[0])
    s = zt.Scalar.from_bytes(ctx["sc"][:n])[0]

    def enc(p):
        return ri._compress(p._tuple()).cpu().numpy().tobytes()

    with tempfile.TemporaryDirectory() as tmpdir:
        one_shot = enc(msm(pts, s))
        full = enc(checkpoint.msm_with_checkpoints(pts, s, block, f"{tmpdir}/a.ckpt"))
        checkpoint.msm_with_checkpoints(pts[:2 * block], s[:2 * block], block,
                                        f"{tmpdir}/b.ckpt")
        stopped_at = checkpoint.load(f"{tmpdir}/b.ckpt", dev)[1]
        resumed = enc(checkpoint.msm_with_checkpoints(pts, s, block,
                                                      f"{tmpdir}/b.ckpt"))
    if not (one_shot == full == resumed == ctx["oracle_wire"](n)) or stopped_at != 2:
        raise AssertionError("msm_with_checkpoints differs from the one-shot MSM")
    phase("checkpoint", f"{n} points in 4 blocks: the checkpointed sum, and the "
          f"job resumed from its file after block {stopped_at}, equal the "
          f"one-shot MSM and the oracle")


def profile_call(label: str, what: str, fn) -> None:
    """One serving call under torch.profiler (phases 15 and 20): wall time,
    device time of the kernel rows (the device busy share) and the kernels
    that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    phase(label, f"{what}: wall {wall_ms:.1f} ms (profiled), device kernels "
          f"{busy_ms:.1f} ms in {launches} launches, busy {busy_ms / wall_ms:.0%}")
    for e in top:
        phase(label, f"{e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x {e.key[:90]}")
    watched = []
    for kernel in WATCHED:
        hits = [e for e in rows if f"zc::{kernel}" in e.key]
        watched.append(f"{kernel} {sum(e.count for e in hits)}x "
                       f"{sum(e.self_device_time_total for e in hits) / 1e3:.3f} ms")
    phase(label, "K1, K2, K8: " + ", ".join(watched))


def profile_copies(label: str, fn, top: int = 8) -> None:
    """Name the callers of the torch.cat / torch.stack copies of one call:
    both functions wrapped for that call, each copy timed by CUDA events
    around it and charged to the first frames of the port that called it
    (the profiler's own stack grouping names none on that machine)."""
    import traceback

    real = {"cat": torch.cat, "stack": torch.stack}
    events = []

    def wrapped(name):
        def copy(*args, **kwargs):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "zerocaf_tpu_torch" in f.filename][::-1][:5]
            where = " <- ".join(f"{f.filename.split('zerocaf_tpu_torch/')[-1]}"
                                f":{f.lineno} {f.name}" for f in frames)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args, **kwargs)
            end.record()
            events.append((f"{name} in {where}", start, end))
            return out
        return copy

    fn()
    torch.cuda.synchronize()
    torch.cat, torch.stack = wrapped("cat"), wrapped("stack")
    try:
        fn()
    finally:
        torch.cat, torch.stack = real["cat"], real["stack"]
    torch.cuda.synchronize()
    by_site = {}
    for where, start, end in events:
        ms, count = by_site.get(where, (0.0, 0))
        by_site[where] = (ms + start.elapsed_time(end), count + 1)
    total = sum(ms for ms, _ in by_site.values())
    phase(label, f"torch.cat and torch.stack: {len(events)} calls, {total:.3f} "
          f"device ms in {len(by_site)} call sites")
    for where, (ms, count) in sorted(by_site.items(), key=lambda kv: -kv[1][0])[:top]:
        phase(label, f"{ms:9.3f} ms {count:5d}x {where}")


if __name__ == "__main__":
    main()
