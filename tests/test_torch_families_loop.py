"""Whole training runs of the hybrid and MoE families: three AdamW steps
of the port's ``train_loop`` against the reference's, under sync and
stale, on zamba2-1.2b's reduced config (a Mamba2 and a shared-attention
layer) and arctic-480b's (two MoE layers with a dense residual) in
float32, from the reference's weights (``init_params`` at PRNGKey(0), as
its ``train_loop`` draws them) on the same ``hmm_stream`` batches.

Runs are held by their losses, within 1e-5 relative
(``_torch_train_parity``)."""

import pytest

from _torch_train_parity import check_train_loop


@pytest.mark.parametrize("strategy", ["sync", "stale"])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "arctic-480b"])
def test_train_loop_matches_reference(arch, strategy):
    check_train_loop(arch, steps=3, batch_size=2, seq_len=32, lr=2e-3,
                     strategy=strategy)
