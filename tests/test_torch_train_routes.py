"""``Model.train_loss``'s other routes against the JAX package's: the
chunked attention core at ``s > 4096`` and the MoE dispatch with capacity
drops (the helpers and tolerances of ``test_torch_train_loss.py``)."""

from __future__ import annotations

import dataclasses

import pytest

from _torch_parity import model_pair
from test_torch_train_loss import (LOSS_TOL, hold_grads, jax_value_and_grad, make_batch,
                                   torch_value_and_grad)


def test_chunked_attention_route_above_4096_matches_jax():
    """zamba2's shared block at s = 4160 takes the chunked core (B4's plain
    version here, ``repro``'s jnp ``chunked_attention`` there) with its
    4096-token window, and the Mamba2 scan runs 260 chunks."""
    cfg, j_model, j_params, t_model, t_params = model_pair("zamba2-1.2b")
    batch = make_batch(cfg, 1, 4160, seed=2)
    j_loss, _, j_grads = jax_value_and_grad(j_model, j_params, batch)
    t_loss, _, t_grads = torch_value_and_grad(t_model, t_params, batch)
    assert abs(t_loss - j_loss) <= LOSS_TOL * abs(j_loss)
    hold_grads(t_grads, j_grads, cfg)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v2-236b"])
def test_moe_gradients_with_capacity_drops_match_jax(arch):
    """At capacity factor 0.3 over 3 x 40 tokens the sort dispatch drops
    (token, choice) pairs (the same pairs as the JAX package's; the loss
    moves against factor 1.25), and the gradients, the router's through
    the gates and the aux loss included, still match."""
    import dataclasses

    cfg, j_model, j_params, t_model, t_params = model_pair(arch)
    batch = make_batch(cfg, 3, 40, seed=4)
    losses = {}
    for factor in (1.25, 0.3):
        j_cfg = dataclasses.replace(j_model.cfg, moe=dataclasses.replace(
            j_model.cfg.moe, capacity_factor=factor))
        t_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
        j_loss, j_parts, j_grads = jax_value_and_grad(
            dataclasses.replace(j_model, cfg=j_cfg), j_params, batch)
        t_loss, t_parts, t_grads = torch_value_and_grad(
            dataclasses.replace(t_model, cfg=t_cfg), t_params, batch)
        assert abs(t_loss - j_loss) <= LOSS_TOL * abs(j_loss)
        assert abs(t_parts["aux"] - j_parts["aux"]) <= LOSS_TOL * abs(j_parts["aux"])
        hold_grads(t_grads, j_grads, cfg)
        losses[factor] = t_loss
    assert losses[0.3] != losses[1.25]
