"""Chi-squared 95% gating table.

The reference builds `boost::math::chi_squared` quantiles on the fly
(`UpdaterMSCKF.cpp:47-55`, up to 500 dof); here the table is
precomputed once at import (scipy) into a device constant so the gate
is a dynamic lookup inside jit.
"""

import jax.numpy as jnp
import numpy as np
from scipy import stats

MAX_DOF = 1024

_table = stats.chi2.ppf(0.95, np.arange(1, MAX_DOF + 1))
# dof index 0 unused; clamp lookups into [1, MAX_DOF]
CHI2_95 = jnp.asarray(np.concatenate([[_table[0]], _table]))


def chi2_95(dof, max_dof: int = 0):
    """95% chi2 quantile for (possibly traced) integer dof.

    When `max_dof` (a static bound, e.g. the padded row count) is given,
    the lookup is a one-hot matmul against a small table slice instead
    of a dynamic gather (not yet timed against the gather on the GPU).
    Without it, falls back to a gather.
    """
    idx = jnp.clip(dof, 1, MAX_DOF)
    if max_dof and max_dof < MAX_DOF:
        table = CHI2_95[: max_dof + 1].astype(jnp.result_type(float))
        # saturate to the largest tabulated quantile: an out-of-range dof
        # must not produce an all-zero one-hot row (threshold 0 would
        # silently reject every measurement at that gate)
        idx = jnp.clip(idx, 1, max_dof)
        onehot = (
            jnp.arange(max_dof + 1) == jnp.asarray(idx)[..., None]
        ).astype(table.dtype)
        return onehot @ table
    return CHI2_95[idx]
