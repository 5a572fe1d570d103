#!/usr/bin/env python3
"""Where K1's and K2's time goes: `csrc/olm_matmul.cu` rebuilt with one part
of its work taken out at a time, each variant timed at `chip_smoke.py`'s
two olm16 shapes.

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit:

    python3 probes/olm_matmul_variants.py

Each variant is the source with a text substitution, built for n = 16
only into `build/variants/`:
  kernel       the source as it is;
  lane_loop    K1/K2's lane (`lane_top`) replaced by olm_lane.cuh's
               `lane_loop`, K3's recurrence, on masks stored as it reads
               them (the same bits, more integer-ALU-pipe instructions);
  no_copies    no operand copies (the prologue reads a stale stage);
  no_prologue  no quantizing (K1) or packing (K2) of the staged slices;
  no_lanes     the recurrence of every lane replaced by an XOR of its
               masks (the tree, prologue and copies stay);
  no_tile      no tile body at all (copies, prologue, accumulation and
               store stay).
Only `kernel` and `lane_loop` compute the product; the script checks both
bit for bit against `olm_matmul_ref`. Variants run in turns, twice
(median of 10 single launches each, cold L2), so a difference is read
within one card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

WIDTHS = ("OLM_CASE(8) OLM_CASE(10) OLM_CASE(12) OLM_CASE(16) OLM_CASE(20)\n"
          "    OLM_CASE(24) OLM_CASE(32)")
LANE = "lane_top<N>("
MASK = "make_uint2(pos << (32 - N), neg << (32 - N))"
PACK = ("if (ok) olm::pack<N, VEC>(stage + j * kRow, olm::swizzle<N>(j), pos,"
        " neg);")
QUANT = "quantize<N>(v, 0xFFFFu << (t & 16), pos, neg, sc);"
REC_A = "lane_top<N>(xa.x, xa.y, wa.x, wa.y, st, ap, an);"
REC_B = "lane_top<N>(xb.x, xb.y, wb.x, wb.y, st, bp, bq);"
TILE = "tile_tree<N, W>(xm, wm, a.st, a.L, zp, zn);"


def _sub(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"olm_matmul.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    src = _sub(src, (WIDTHS, "OLM_CASE(16)"))
    return {
        "kernel": src,
        "lane_loop": _sub(src, (LANE, "olm::lane_loop<N>("),
                          (MASK, "make_uint2(pos, neg)")),
        "no_copies": _sub(src, ("    request(c + 1);\n", "\n"),
                          ("  request(0);\n", "\n")),
        "no_prologue": _sub(src, (PACK, "pos = j; neg = 0;"),
                            (QUANT, "pos = __float_as_int(v); neg = 0u; "
                                    "sc = 1.0f;")),
        "no_lanes": _sub(src, (REC_A, "ap = xa.x ^ wa.x; an = xa.y ^ wa.y;"),
                         (REC_B, "bp = xb.x ^ wb.x; bq = xb.y ^ wb.y;")),
        "no_tile": _sub(src, (TILE, "zp = xm[0].x ^ wm[1].y; zn = xm[2].y;")),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("olm_matmul_variants: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (DECODE_GEMV, PREFILL_GEMM, bits_equal, cuda_ms,
                            operands, smi)
    from repro_torch.kernels import build
    from repro_torch.kernels.online_dot import matmul_kernel as k12
    from repro_torch.kernels.online_dot.matmul import (_quantize_tiles,
                                                       _tile_plan,
                                                       olm_matmul_ref)
    smi_line = smi("name,power.limit")
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi_line}", flush=True)
    srcs = variants((build.CSRC / k12.SOURCE).read_text())
    procs = {}
    for name, src in srcs.items():
        out = build.BUILD_ROOT.parent / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for header in build.CSRC.glob("*.cuh"):
            (out / header.name).write_text(header.read_text())
        (out / k12.SOURCE).write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / "lib.so"),
             str(out / k12.SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(build.BUILD_ROOT.parent / "variants" / name
                              / "lib.so"))
        lib.olm_matmul_fused.argtypes = [P, P, P, I, I, I, LL, LL, I, I, I, I,
                                         P, I, I, I, I, P]
        lib.olm_matmul_host.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P,
                                        I, I, I, I, I, P]
        lib.olm_matmul_fused.restype = lib.olm_matmul_host.restype = I
        libs[name] = lib
    dev = torch.device("cuda", 0)
    arr, S, L = k12._schedule(16, 16)
    cases = []
    for shape in (DECODE_GEMV, PREFILL_GEMM):
        M, K, N = shape
        x, w = operands(shape, 3, dev)
        kt, T, xp, wpT = _tile_plan(x, w, 16)
        xd, sx = (t.contiguous() for t in _quantize_tiles(xp, kt, T, 16))
        wd, sw = (t.contiguous() for t in _quantize_tiles(wpT, kt, T, 16))
        out = torch.empty((M, N), device=dev)
        p1 = k12.launch_plan(M, N, K, 16)
        p2 = k12.launch_plan(M, N, K, 16, host=True, vec=True)
        cases.append((shape, olm_matmul_ref(x, w), out, (
            ("K1", lambda lib, x=x, w=w, out=out, M=M, N=N, K=K, p=p1:
             lib.olm_matmul_fused(
                 x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                 w.stride(0), w.stride(1), 16, 16, L, S, arr, len(arr), p.bm,
                 p.bn, p.tb, torch.cuda.current_stream().cuda_stream)),
            ("K2", lambda lib, t=(xd, sx, wd, sw), out=out, M=M, N=N, T=T,
             p=p2: lib.olm_matmul_host(
                 *(v.data_ptr() for v in t), out.data_ptr(), M, N, T, 16, 16,
                 L, S, arr, len(arr), p.bm, p.bn, p.tb, 1,
                 torch.cuda.current_stream().cuda_stream)))))
    for rnd in range(2):
        for name, lib in libs.items():
            for shape, want, out, fns in cases:
                parts = []
                for kernel, fn in fns:
                    if fn(lib) != 0:
                        raise SystemExit(f"{name} {kernel} launch failed")
                    torch.cuda.synchronize()
                    same = bits_equal(out, want)
                    if name in ("kernel", "lane_loop") and not same:
                        raise SystemExit(f"{name} {kernel} {shape} disagrees "
                                         "with olm_matmul_ref")
                    ms = cuda_ms(lambda: fn(lib), reps=10, warmup=1)
                    parts.append(f"{kernel} {ms:.4f} ms")
                print(f"[variant] round {rnd} {name} M,K,N={shape}: "
                      + "; ".join(parts), flush=True)
    print(smi_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
