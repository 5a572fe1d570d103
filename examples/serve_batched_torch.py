"""Serve a small model with continuous batching, in the PyTorch port (the
twin of examples/serve_batched.py).

Runs the same request stream through the paged KV cache and the
contiguous layout with `repro_torch.launch.serve`, and prints the latency
percentiles and the KV residency of each layout. On the CUDA card unless
told otherwise:

  PYTHONPATH=src python examples/serve_batched_torch.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    common = [
        "--arch", "internlm2_1_8b", "--smoke",
        "--requests", "10", "--slots", "4",
        "--max-new", "12", "--max-len", "96",
    ]
    if args.device:
        common += ["--device", args.device]
    paged = serve_main(common + ["--kv-layout", "paged",
                                 "--kv-block-size", "8"])
    contig = serve_main(common + ["--kv-layout", "contiguous"])
    print("served", paged["n"], "requests; TTFT p50",
          f"{paged['ttft_p50_s'] * 1e3:.1f} ms, p99",
          f"{paged['ttft_p99_s'] * 1e3:.1f} ms,",
          f"{paged['tokens_per_s']:.1f} tok/s")
    kvp, kvc = paged["kv"], contig["kv"]
    print("KV resident: paged", kvp["kv_bytes_resident"], "B vs contiguous",
          kvc["kv_bytes_resident"], "B",
          f"({kvp['kv_bytes_resident'] / kvc['kv_bytes_resident']:.1%})")
    return paged, contig


if __name__ == "__main__":
    main()
