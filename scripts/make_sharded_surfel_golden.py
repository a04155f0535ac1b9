"""Write tests/golden/sharded_surfel.npz: the reference package's
single-device 2DGS training loss, its gradient and the two views' images on
the inputs of tests/torch_parallel_cases.py's surfel world, with the
SHA-256 of those inputs (``surfel_golden_digest``).

The loss is tests/test_sharding.py's single-device reference
(tests/sharded_surfel_reference.py), evaluated eagerly: under jax.jit, XLA
on the CPU rewrites the surfel alpha into other roundings (an
alpha-threshold flip moves a pixel, and the gradient of the gaussians
under it moves by up to 2e-6 of a 6.5e-2 scale), while eagerly it matches
the port's single-device gradient within 5e-8. The eager gradient takes
about 30 s on the CPU, longer than a test file may run, so
tests/test_torch_sharding_surfel.py reads it from this file; it also holds
the port to the jit gradient, counting the flipped pixels. This script
prints that comparison for the golden itself: the pixels where the eager
and jit images differ by more than 1e-5, and the gradient values outside
atol 1e-6 / rtol 1e-4.

    JAX_PLATFORMS=cpu python scripts/make_sharded_surfel_golden.py
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from sharded_surfel_reference import reference  # noqa: E402
from torch_parallel_cases import surfel_golden_digest  # noqa: E402

OUT = ROOT / "tests" / "golden" / "sharded_surfel.npz"


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    eager = reference(jit=False)
    np.savez(OUT, inputs_sha256=np.asarray(surfel_golden_digest()), **eager)
    print(f"wrote {OUT.relative_to(ROOT)}: loss {float(eager['loss']):.9e}")
    jit = reference(jit=True)
    flips = int((np.abs(jit["images"] - eager["images"]).max(-1) > 1e-5).sum())
    print(f"jit: loss {float(jit['loss']):.9e}; {flips} pixels differ by more than 1e-5")
    for k in sorted(k for k in eager if k.startswith("grad_")):
        a, b = jit[k], eager[k]
        off = np.abs(a - b) > 1e-6 + 1e-4 * np.abs(b)
        print(f"  {k}: max diff {np.abs(a - b).max():.3e} (scale {np.abs(b).max():.3e}); "
              f"{int(off.sum())} values off, rows {np.unique(np.nonzero(off)[0]).tolist()}")


if __name__ == "__main__":
    main()
