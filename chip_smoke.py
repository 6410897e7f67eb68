#!/usr/bin/env python3
"""Drive the PyTorch port's ECDH serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order (any failure raises, so the exit code is non-zero):
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: compile (or load) the kernel library from zerocaf_tpu_torch/csrc;
  3. kernels: K1-K4 against their plain PyTorch versions at the main path's
     shapes, limb for limb, with CUDA-event times of both;
  4. vectors: the 16 Ristretto small multiples, the Elligator sage vector
     and [2]B, byte for byte;
  5. ECDH at batch 32768: public keys by the ladder (K3), shared secrets by
     Engine.dh (K4, with K1/K2 in decode and encode), checked against each
     other and against the oracle on sampled lanes; one invalid peer lane
     must be rejected;
  6. Engine.hash_to_group at batch 32768, sampled lanes against the oracle;
  7. launch counts: every kernel must have run during phases 5-6;
  8. rates: dh and hash_to_group ops/s (median of 11 calls on the host
     clock, with the min and max) and ladder mults/s.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Needs a CUDA device: there is
no CPU path.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

BATCH = 32768                 # Engine default: the serving batch
MUL_LANES = 1 << 16           # K1 checked at 2^16 lanes
SAMPLE = 32                   # lanes checked against the oracle
TOLERANCE = 0                 # integer limb algebra: kernels equal plain versions
RATE_CALLS = 11               # serving calls timed for each rate (median)
SEED = 20261016
SOURCE = "zerocaf_tpu_torch/csrc/field_kernels.cu"
TPU_KERNELS = "zerocaf_tpu/ops/pallas/field_kernels.py"

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

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f" torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    path, nvcc_s, log = build.build()
    build.load(dev)
    phase("build", f"{path.name} nvcc {nvcc_s:.1f}s, ready in "
          f"{time.perf_counter() - t0:.1f}s")
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers",
                                   "spill stores", "bytes stack frame")):
            phase("ptxas", line.strip())

    def rand_bytes(shape):
        return torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)

    def rand_elems(n, spec):
        return limb.canonical(limb.from_bytes(rand_bytes((n, 32)), spec), spec)

    # 3. kernels against their plain versions ------------------------------
    results = {}

    def record(wrapper, err, ms=None, plain_ms=None):
        r = results.setdefault(wrapper.__name__, {"max_abs_err": 0, "ms": None,
                                                  "plain_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if ms is not None:
            r["ms"], r["plain_ms"] = ms, plain_ms

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
            record(fk.mul_tiled, err, ms, plain)
        else:
            record(fk.mul_tiled, err)

    x = limb.sub(fk.mul_tiled_ref(rand_elems(BATCH, limb.FIELD),
                                  rand_elems(BATCH, limb.FIELD)),
                 rand_elems(BATCH, limb.FIELD))
    for e in C.CHAIN_EXPONENTS:
        err = max_abs_err(fk.pow_tiled(x, e), fk.pow_tiled_ref(x, e))
        msg = (f"e={hex(e)[:12]}.. {BATCH} lanes: max_abs_err {err} "
               f"(tolerance {TOLERANCE})")
        if err > TOLERANCE:
            raise AssertionError(f"K2 differs from its plain version: {msg}")
        if e == C.EXP_SQRT_RATIO:       # the exponent every encode/decode runs
            ms = cuda_ms(lambda: fk.pow_tiled(x, e), 10)
            plain = cuda_ms(lambda: fk.pow_tiled_ref(x, e), 2)
            msg += f", kernel {ms:.4f} ms, plain {plain:.4f} ms"
            record(fk.pow_tiled, err, ms, plain)
        else:
            record(fk.pow_tiled, err)
        phase("K2 pow_tiled", msg)

    # random points of the prime-order group, random canonical scalars
    pts = zt.RistrettoPoint.from_uniform_bytes(rand_bytes((BATCH, 64))).point._tuple()
    pts = tuple(c.contiguous() for c in pts)
    s = zt.Scalar.from_bytes_wide(rand_bytes((BATCH, 64)))
    ladder_cases = (
        (fk.scalar_mul_windowed_stepped, fk.scalar_mul_windowed_stepped_ref,
         s.into_bits(250), 1, "K3 ladder (width 1)"),
        (fk.scalar_mul_windowed_signed, fk.scalar_mul_windowed_signed_ref,
         s.windows(4, 63), 4, "K4 signed windows (width 4)"),
    )
    for wrapper, ref, win, width, label in ladder_cases:
        got = wrapper(pts, win, width)
        want = ref(pts, win, width)
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: wrapper(pts, win, width), 3)
        plain = cuda_ms(lambda: ref(pts, win, width), 1)
        phase(label, f"{BATCH} lanes: max_abs_err {err} (tolerance {TOLERANCE}), "
              f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
        if err > TOLERANCE:
            raise AssertionError(f"{label} differs from its plain version")
        record(wrapper, err, ms, plain)
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
    counts = fk.launch_counts()

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

    replaces = {"mul_tiled": 1133, "pow_tiled": 1030,
                "scalar_mul_windowed_stepped": 704,
                "scalar_mul_windowed_signed": 825}
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": f"{TPU_KERNELS}:{line}", "launches": counts[name],
                **results[name]} for name, line in replaces.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
