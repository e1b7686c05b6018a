"""Shared checks of ``tests/test_torch_recsys.py`` and ``tests/test_torch_gnn.py``:
a model's gradients and one Adam step held to JAX's (fp32, SMOKE widths).

Tolerances (``tests/_torch_lm_parity.py``'s): gradients each leaf within
1e-4 x max |JAX grad of that leaf| + 1e-7; one Adam step by
:func:`check_step`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro.common.pytree import named_leaves as jnamed

from repro_torch.common.pytree import named_leaves


def T(x):
    return torch.as_tensor(np.array(x))


def port_batch(b):
    return {k: T(v) for k, v in b.items()}


def check_grads(grads, jgrads):
    want = jnamed(jgrads)
    got = named_leaves(grads)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-7,
                                   err_msg=n)


def check_step(p2, o2, m, jp2, jo2, jm, lr=1e-3):
    """One Adam step: loss and grad norm rtol 1e-5; params within 1e-5 where
    the new first moment is above 1e-3 x its max, within 2 x lr elsewhere
    (a gradient at rounding level moves its parameter by up to lr either
    way); first moments within 1e-4 x their max."""
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert int(o2.step) == int(jo2.step)
    mu = dict(named_leaves(o2.mu))
    for (n, got), (_, want), (_, jmu) in zip(named_leaves(p2), jnamed(jp2), jnamed(jo2.mu)):
        want, jmu = np.asarray(want), np.asarray(jmu)
        big = np.abs(jmu) > 1e-3 * np.abs(jmu).max()
        np.testing.assert_allclose(got.numpy()[big], want[big], rtol=0, atol=1e-5, err_msg=n)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * lr, err_msg=n)
        np.testing.assert_allclose(mu[n].numpy(), jmu, rtol=0,
                                   atol=1e-4 * np.abs(jmu).max() + 1e-9, err_msg=n)
