"""Debug-mode numeric discipline: checkify + jax.debug NaN watches.

The SURVEY.md section-5 auxiliary plan for sanitizers in a pure-
functional JAX stack: no ASan/TSan analog exists or is needed, but two
failure classes do — out-of-bounds gathers (silently clamped by XLA)
and NaNs escaping the masked-NaN convention the pipeline threads
through every layer (NaN = invalid depth/normal is LEGAL inside the
programs; NaN in a kept output pose is a bug).

Two opt-in tools, zero overhead when off:

* ``checked(fn)``: wraps a jittable function with
  ``jax.experimental.checkify`` index/NaN error functionalization and
  raises on the first violation. Use in tests and debugging sessions —
  checkified programs run slower and allocate error state.
* ``nan_watch(x, name)``: inside any jitted program, emits a host
  warning when ``x`` contains NaN — but ONLY when debug mode is active
  at trace time (``ODT_DEBUG=1`` or :func:`enable`); otherwise it
  traces to nothing. The fused detect program watches its kept output
  poses this way.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

_ENABLED = os.environ.get("ODT_DEBUG", "") not in ("", "0")


def enable(on: bool = True) -> None:
    """Turn debug watches on/off for subsequently TRACED programs
    (already-compiled programs are unaffected — recompile to apply)."""
    global _ENABLED
    _ENABLED = on


def debug_enabled() -> bool:
    return _ENABLED


def checked(fn: Callable, checks: Sequence[str] = ("index", "nan")) -> Callable:
    """Checkify-wrapped ``fn``: raises JaxRuntimeError on the first
    out-of-bounds index ("index"), NaN produced by a primitive ("nan"),
    zero division ("div"), or failed explicit checkify.check ("user").
    """
    from jax.experimental import checkify

    sets = {
        "index": checkify.index_checks,
        "nan": checkify.nan_checks,
        "div": checkify.div_checks,
        "user": checkify.user_checks,
    }
    errors = frozenset()
    for c in checks:
        errors = errors | sets[c]
    cfn = checkify.checkify(fn, errors=errors)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return run


def nan_watch(x: jnp.ndarray, name: str, mask=None) -> jnp.ndarray:
    """Pass-through NaN watch: when debug mode was active at trace time,
    emits a host-side warning if any (optionally ``mask``-selected)
    element of ``x`` is NaN. Returns ``x`` unchanged either way."""
    if not _ENABLED:
        return x
    bad = jnp.isnan(x)
    if mask is not None:
        bad = bad & mask
    n_bad = jnp.sum(bad)

    def report(n):
        if int(n) > 0:
            print(f"[odt nan_watch] {name}: {int(n)} NaN element(s)", flush=True)

    jax.debug.callback(report, n_bad)
    return x
