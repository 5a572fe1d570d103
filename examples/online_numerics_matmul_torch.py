"""The paper's technique as model numerics, in the PyTorch port, selected
through one DotEngine dispatch surface (the twin of
examples/online_numerics_matmul.py): truncated-precision digit-plane
matmul (tpmm, the Hopper kernel K5 on the card) against exact, the fused
digit-serial inner-product array (olm, the kernel K1) computing float
matmul tiles the way the paper's PE array would, an MLP forward under
olm16, and a smoke model forward under tpmm16.

Runs on the CUDA card unless told otherwise; on the CPU every wrapper runs
its plain PyTorch version, which gives the same bits:

  PYTHONPATH=src python examples/online_numerics_matmul_torch.py
  PYTHONPATH=src python examples/online_numerics_matmul_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.numerics import DotEngine
from repro_torch.kernels.online_dot import (matmul_kernel, olm_error_bound,
                                            olm_matmul, olm_matmul_ref)
from repro_torch.kernels.tpmm import kernel as tpmm_kernel
from repro_torch.kernels.tpmm.ops import tpmm, tpmm_cost_model
from repro_torch.models import layers
from repro_torch.models.model import Model


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu for the plain "
                           "versions")
    out = {"device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else "cpu"}
    launched = (matmul_kernel.launches, tpmm_kernel.launches)

    # 0) the dispatch surface: every mode is a registered DotMode
    print("DotEngine mode registry (error / cost trade-offs):")
    for m in DotEngine.mode_table():
        print(f"  {m.name:>7}: {m.summary}")
        print(f"  {'':>7}  error: {m.error}; cost: {m.cost}")

    # 1) raw tpmm op: error/cost trade-off (K5 on the card)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 256)).astype(np.float32)
    exact = a @ b
    print("\ntpmm error / plane-matmul savings (paper Eq. 8 transposed to "
          "planes):")
    out["tpmm_rel"] = {}
    for nb in (8, 16, 24):
        got = tpmm(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                   n_bits=nb).cpu().numpy()
        rel = float(np.max(np.abs(got - exact)) / np.abs(exact).max())
        out["tpmm_rel"][nb] = rel
        cm = tpmm_cost_model(nb)
        print(f"  n_bits={nb:2d}: rel err {rel:.2e}, "
              f"{cm['pair_matmuls_truncated']}/{cm['pair_matmuls_full']} "
              f"plane-matmuls ({cm['mxu_savings_pct']:.1f}% saved)")

    # 2) the fused inner-product array as a float matmul: K1 quantizes each
    #    K tile in the kernel, runs the multiplier lanes and the online
    #    adder tree per output and decodes exactly - bit-identical to the
    #    plain version
    n, M, K, N = 16, 4, 24, 4
    at = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    bt = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    got = olm_matmul(at.to(dev), bt.to(dev), n_bits=n, block_m=4,
                     block_n=4).cpu()
    ref = olm_matmul_ref(at, bt, n_bits=n)
    bound = olm_error_bound(at, bt, n_bits=n)
    err = (got - at @ bt).abs()
    out["olm_bitwise"] = bool(torch.equal(got.view(torch.int32),
                                          ref.view(torch.int32)))
    out["olm_bound_used"] = float((err / bound).max())
    print(f"\nolm_matmul: {M}x{K}x{N} tile, n={n} digits on {dev.type}: "
          f"== plain version bitwise: {out['olm_bitwise']}, "
          f"max |err| = {float(err.max()):.2e} "
          f"(documented bound {float(bound.max()):.2e}, "
          f"{out['olm_bound_used'] * 100:.0f}% used)")

    # 3) an MLP forward through the array numerics (K1 on the card)
    cfg = smoke_config("internlm2_1_8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = layers.mlp_init(gen, cfg, dev)
    x = torch.randn((2, 4, cfg.d_model), generator=gen, device=dev)
    y_native = layers.mlp_apply(p, cfg, x, DotEngine(mode="native"))
    y_olm = layers.mlp_apply(p, cfg, x, DotEngine(mode="olm16"))
    dy = float((y_olm - y_native).abs().max())
    out["mlp_rel"] = dy / float(y_native.abs().max())
    print(f"\nMLP forward (d={cfg.d_model}, ff={cfg.d_ff}), native vs olm16: "
          f"max |dy| = {dy:.2e} (rel {out['mlp_rel']:.2e})")

    # 4) a whole smoke model's forward under tpmm numerics (K5 on the card)
    m_exact = Model(cfg, DotEngine(mode="native"), device=dev)
    m_tp = Model(cfg, DotEngine(mode="tpmm16"), device=dev)
    params = m_exact.init(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)))
    with torch.no_grad():
        le, _ = m_exact.forward(params, {"tokens": tokens})
        lt, _ = m_tp.forward(params, {"tokens": tokens})
    out["finite"] = bool(torch.isfinite(le).all() and torch.isfinite(lt).all())
    out["argmax_agree"] = float((le.argmax(-1) == lt.argmax(-1))
                                .float().mean())
    print(f"\nmodel forward, native vs tpmm16 numerics: "
          f"max |dlogit| = {float((le - lt).abs().max()):.3f}, "
          f"argmax agreement = {out['argmax_agree'] * 100:.1f}%")
    out["launches"] = {"olm_matmul_fused": matmul_kernel.launches - launched[0],
                       "tpmm": tpmm_kernel.launches - launched[1]}
    print(f"\nkernel launches on {out['device']}: {out['launches']}")
    return out


if __name__ == "__main__":
    main()
