"""P12 (``probes/cast_test.py:try_cast``) on the card: nine in-kernel
relayouts (reshape, transpose, concatenation) of a (T·N2·N1,) = 16384
float32 input, each one kernel through shared memory.

Run: ``python -m rtl_power_fftw_tpu_torch.probes.cast_test [case ...]
[--device cpu|cuda]`` with cases A..I (default: all). Prints one line per
case, ``name tile per-step µs GS/s exact|MISMATCH``: GS/s counts elements
moved; exact means equal to torch's own reshape/permute/cat. Exits 1 if
any case is not exact.
"""

import sys

import torch

from ..ops.kernels import fused_psd_probe as fpp
from ._timing import card, device_or_none, parse, slope_us


def main(argv=None) -> int:
    args = parse(argv, "python -m rtl_power_fftw_tpu_torch.probes.cast_test",
                 "P12 (probes/cast_test.py:16) on the port's kernels")
    cases = args.variants or list(fpp.RELAYOUTS)
    unknown = [c for c in cases if c not in fpp.RELAYOUTS]
    if unknown:
        print(f"unknown P12 case(s) {', '.join(unknown)}; known: "
              f"{', '.join(fpp.RELAYOUTS)}", file=sys.stderr)
        return 2
    dev = device_or_none(args.device)
    if dev is None:
        return 1
    print(f"# P12 (probes/cast_test.py:16) on {card(dev)}: T, N1, N2, P, Q "
          f"= {fpp.T}, {fpp._N1}, {fpp._N2}, {fpp.P}, {fpp.Q}")
    ok = True
    for case in cases:
        r = fpp.RELAYOUTS[case]
        n = fpp.T * fpp._N1 * fpp._N2
        x = torch.arange(n, dtype=torch.float32, device=dev).reshape(
            r.in_shape)
        got = fpp.relayout(case, x)
        exact = torch.equal(got, fpp.relayout_reference(case, x))
        ok = ok and exact
        if dev.type == "cuda":
            per = slope_us(lambda it: fpp.relayout(case, x, iters=it))
            timing = f"per-step {per:8.2f} us  {n / per / 1e3:7.3f} GS/s"
        else:
            timing = "per-step not measured (cpu)"
        print(f"{r.name:18s} tile=  - {timing}  "
              f"{'exact' if exact else 'MISMATCH'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
