"""Quickstart (the PyTorch port): the paper's multiplier, digit by digit.

The twin of examples/quickstart.py over the port's own plain-Python copies
of the paper's models (`repro_torch.core`): one online multiplication MSDF
(watch output digits appear while input digits are still arriving), the
truncated-precision version, a pipelined inner-product array (paper
Table III timing), and the hardware cost model (paper Table I). It prints
the same numbers as the original; no device is involved.

  PYTHONPATH=src python examples/quickstart_torch.py
"""
import numpy as np

from repro_torch.core.hwmodel import online_multiplier_cost
from repro_torch.core.inner_product import online_dot_pipelined
from repro_torch.core.online_mul import OnlineMulState
from repro_torch.core.precision import OnlinePrecision, reduced_precision
from repro_torch.core.sd import digits_to_frac, frac_to_digits


def main(argv=None):
    n = 8
    x, y = 0.40625, -0.7265625
    xd, yd = frac_to_digits(x, n), frac_to_digits(y, n)
    print(f"x = {x} -> digits {xd}")
    print(f"y = {y} -> digits {yd}")

    print(f"\nMSDF execution (n={n}, delta=3, truncated p="
          f"{reduced_precision(n)} of {n} slices):")
    cfg = OnlinePrecision(n=n)
    st = OnlineMulState(cfg)
    step = 0
    while not st.done:
        out = st.step(xd, yd)
        q = step - cfg.delta + 1 + cfg.delta
        in_dig = f"in: x_{q}={xd[q-1] if q <= n else 0:+d}" if q <= n else "in: --"
        out_s = f"out: z={out:+d}" if out is not None else "out: (delay)"
        print(f"  cycle {step:2d}  {in_dig:14s} {out_s:14s} "
              f"live slices: {st.active[-1]}")
        step += 1
    z = digits_to_frac(st.z_digits)
    print(f"product = {z}  (exact {x * y}, error {abs(z - x * y):.2e} "
          f"= {abs(z - x * y) * 2**n:.3f} ulp)")

    # pipelined inner product (the paper's target workload)
    k = 8
    rng = np.random.default_rng(0)
    xs = [frac_to_digits(v, n) for v in rng.uniform(-0.9, 0.9, k)]
    ys = [frac_to_digits(v, n) for v in rng.uniform(-0.9, 0.9, k)]
    r = online_dot_pipelined(xs, ys)
    want = sum(digits_to_frac(a) * digits_to_frac(b) for a, b in zip(xs, ys))
    print(f"\npipelined dot (k={k}): {r.dot_value:.6f} (exact {want:.6f}) "
          f"in {r.cycles} cycles — paper Table III: (n+delta+1)+(k-1) = "
          f"{(n + 3 + 1) + (k - 1)} + adder-tree delay")

    # hardware cost model (paper Table I)
    print("\narea/power model (gate-equivalents, MCNC costs):")
    for nn in (8, 16, 24, 32):
        full = online_multiplier_cost(OnlinePrecision(nn, truncated=False,
                                                      tail_gating=False))
        red = online_multiplier_cost(OnlinePrecision(nn))
        print(f"  n={nn:2d}: area {full.area:8.0f} -> {red.area:8.0f} "
              f"({100 * (1 - red.area / full.area):.1f}% saved), "
              f"latches {full.latches} -> {red.latches}")


if __name__ == "__main__":
    main()
