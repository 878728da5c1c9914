"""mathlib — the JAX equivalent of the reference's MathLib (ml.hlsli).

Pure jnp functions, vectorized over arbitrary leading batch dims; vectors are
length-3 trailing axes. See SURVEY.md §2.3 "MathLib" row.
"""

from nrdsample_tpu.mathlib import brdf, color, filtering, geometry, packing, rng, sampling  # noqa: F401
