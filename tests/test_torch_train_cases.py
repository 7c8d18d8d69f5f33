"""``tests/test_diffusion.py``'s training cases
(``test_training_reduces_loss[XL, F3]`` and
``test_distillation_tracks_teacher``) run on both packages as cases of
one parametrised test: the JAX package's ``train_model`` and the port's
(``repro_torch/diffusion/train.py``, on the CPU), each from its own
seeded draws, held to the reference's own assertions.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.diffusion import families as jfam
from repro.diffusion import train as jt
from repro_torch.diffusion import train as tt

torch.set_num_threads(1)


def _reduces_loss(pkg, fam):
    if pkg == "jax":
        _, losses = jt.train_model(jax.random.PRNGKey(0), fam, "small",
                                   steps=30, batch=32)
    else:
        _, losses = tt.train_model(0, fam, "small", steps=30, batch=32,
                                   device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def _distillation_tracks_teacher(pkg):
    if pkg == "jax":
        teacher, _ = jt.train_model(jax.random.PRNGKey(1), "F3", "large",
                                    steps=25, batch=32)
        _, losses = jt.train_model(
            jax.random.PRNGKey(2), "F3", "small", steps=25, batch=32,
            teacher=(teacher, jfam.NET_CONFIGS[("F3", "large")]))
    else:
        teacher, _ = tt.train_model(1, "F3", "large", steps=25, batch=32,
                                    device="cpu")
        _, losses = tt.train_model(2, "F3", "small", steps=25, batch=32,
                                   teacher=teacher, device="cpu")
    assert losses[-1] < losses[0]


# tests/test_diffusion.py's training cases, each a function of the package
CASES = {
    "training_reduces_loss[XL]": lambda pkg: _reduces_loss(pkg, "XL"),
    "training_reduces_loss[F3]": lambda pkg: _reduces_loss(pkg, "F3"),
    "distillation_tracks_teacher": _distillation_tracks_teacher,
}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_training_cases(case, pkg):
    CASES[case](pkg)
