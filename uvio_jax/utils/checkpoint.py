"""Filter-state checkpoint / resume.

The reference has NO estimator checkpointing (SURVEY.md §5: output-side
text streams only; `initialize_with_gt` is the closest thing to a warm
start). Here the entire estimator is one pytree + a tiny host mirror,
so save/resume is a single npz — useful for long-sequence restarts and
fault recovery that the reference cannot do.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np


def save_state(path: str, state, host_meta: dict) -> None:
    """Write a FilterState pytree + host bookkeeping to one .npz."""
    flat = {
        f"state/{f.name}": np.asarray(getattr(state, f.name))
        for f in dataclasses.fields(state)
    }
    flat["__meta__"] = np.frombuffer(
        json.dumps(host_meta).encode(), dtype=np.uint8
    )
    np.savez(path, **flat)


def load_state(path: str, template):
    """Read back (FilterState, host_meta). `template` supplies the
    pytree structure and dtypes (build it with the same config)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        restored = {
            f.name: jnp.asarray(
                z[f"state/{f.name}"], jnp.asarray(getattr(template, f.name)).dtype
            )
            for f in dataclasses.fields(template)
        }
    return template.replace(**restored), meta
