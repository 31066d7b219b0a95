"""A run with the timed path broken underneath comes out not correct:
once for each fault a training cell can have, planted in the program on
the CPU at a small size (the harness's look for a card skipped)."""

import numpy as np
import pytest
import torch

from trainbench import harness
from trainbench.tests import tiny


def _unchanged(monkeypatch, P):
    # the step returns its state unchanged
    monkeypatch.setattr(P["opt_mod"], "apply_updates",
                        lambda params, updates: params)


def _half_batch(monkeypatch, P):
    # half of the blocks left out, the mean taken over the rest
    real = P["coded_train"].coded_loss_fn_dedup

    def half(params, batch, v, cfg, norm_scale=1.0, norm=None):
        n = batch["labels"].shape[0] // 2
        kept = {k: x[:n] for k, x in batch.items()}
        return real(params, kept, v[:n], cfg, norm=norm / 2)
    monkeypatch.setattr(P["coded_train"], "coded_loss_fn_dedup", half)


def _token(monkeypatch, P):
    # a token altered where the batcher produces it
    real = P["CodedBatcher"].unique_blocks

    def altered(self, batch):
        out = real(self, batch)
        out["labels"] = out["labels"].copy()
        out["labels"][0, 0, :8] = (out["labels"][0, 0, :8] + 1) % 300
        return out
    monkeypatch.setattr(P["CodedBatcher"], "unique_blocks", altered)


def _answer(monkeypatch, P):
    # the decoder's answer altered where it is produced
    real = P["coded_train"].CodingRuntime.weights_lookahead

    def altered(self, horizon):
        W, alive = real(self, horizon)
        W = W.copy()
        W[:, np.argmax(W[0])] *= 1.5
        return W, alive
    monkeypatch.setattr(P["coded_train"].CodingRuntime, "weights_lookahead",
                        altered)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "token": _token, "answer": _answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    P = harness._program()
    FAULTS[fault](monkeypatch, P)
    c = tiny.cell("granite-3-8b-8L", seq_len=16)
    res = harness.run(c, 5, 0.05, False, torch.device("cpu"), t_start=0.0)
    assert not res["check"]["correct"], res["check"]["numbers"]


def test_sound_run_is_correct():
    c = tiny.cell("granite-3-8b-8L", seq_len=16)
    res = harness.run(c, 5, 0.05, False, torch.device("cpu"), t_start=0.0)
    assert res["check"]["correct"], res["check"]["numbers"]
