"""The correctness check catches a broken timed path: a run of the tiny
cell on the CPU (the harness's look for a card skipped) with a fault
planted in the program underneath comes out ``correct: false``, and the
same run without it ``correct: true``.  Faults: the cache maintenance
step returning the cache unchanged; half of a tick's slots left out of
the attention (the halves in turn); every decoded token altered where it
is sampled.  (The exchange between chips has no fault here: both cells
run on one card.)
"""
import pytest

pytest.importorskip("torch")

import tinycell  # noqa: E402


# sampled requests, at a temperature and nucleus narrow enough on the tiny
# cell's weights that an altered token falls outside the nucleus
SAMPLED = dict(tinycell.MIX, temperature=0.5, top_p=0.5)
SAMPLED_LIMITS = {"nucleus_excess": 1e-3, "schedule_bad": 0}


def _tiny(tmp_path, moe=False, snapshot=False, mix=tinycell.MIX,
          limits=None):
    return tinycell.make_root(tmp_path, tinycell.config(moe), dict(
        mix, snapshot_prefill=snapshot), limits)


@pytest.mark.parametrize("moe,snapshot,mix", [
    (False, False, tinycell.MIX), (True, False, tinycell.MIX),
    (False, True, tinycell.MIX), (False, False, tinycell.OPEN_MIX),
    (True, False, tinycell.OPEN_MIX), (False, False, SAMPLED)],
    ids=["dense", "moe", "dense_from_prefill", "dense_open_loop",
         "moe_open_loop", "dense_sampled"])
def test_clean_run_is_correct(tmp_path, capsys, moe, snapshot, mix):
    limits = SAMPLED_LIMITS if mix is SAMPLED else None
    res = tinycell.run_cell(_tiny(tmp_path, moe, snapshot, mix, limits),
                            capsys)
    assert res["correct"] is True
    assert res["checks"]["compared_tokens"]["value"] > 20
    assert list(res)[-1] == "checks"
    if mix is SAMPLED:
        assert "logit_gap" not in res["checks"]
        assert res["checks"]["nucleus_excess"]["value"] <= 1e-3


def _state_unchanged(eng):
    eng._advance = lambda i, sparsity, n_new: None


def _half_batch(eng):
    from repro_torch.serving import engine as E
    fused, calls = E.K.paged_decode_attention_fused, [0]

    def half(*args):
        # each tick leaves out one half of the slots, the halves in turn
        out = fused(*args).clone()
        r = out.shape[1] // 2
        calls[0] += 1
        out[:, slice(r, None) if calls[0] % 2 else slice(0, r)] = 0
        return out
    E.K = _Ops(E.K, paged_decode_attention_fused=half)


def _token_altered(eng):
    trip, vocab = eng._trip, eng.mcfg.vocab_size

    def altered(active, feed):
        tokens, logits = trip(active, feed)
        return (tokens + 1) % vocab, logits
    eng._trip = altered


class _Ops:
    """The kernel module with one entry replaced."""

    def __init__(self, mod, **over):
        self._mod, self._over = mod, over

    def __getattr__(self, name):
        return self._over.get(name, getattr(self._mod, name))


@pytest.mark.parametrize("snapshot", [False, True],
                         ids=["own_prefill", "from_prefill"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
def test_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault,
                              snapshot):
    from repro_torch.serving import engine as E
    monkeypatch.setattr(E, "K", E.K)       # restored after the test
    res = tinycell.run_cell(_tiny(tmp_path, snapshot=snapshot), capsys,
                            faults=fault)
    assert res["correct"] is False
    gap = res["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


def test_sampled_token_altered_is_not_correct(tmp_path, capsys):
    res = tinycell.run_cell(_tiny(tmp_path, mix=SAMPLED,
                                  limits=SAMPLED_LIMITS), capsys,
                            faults=_token_altered)
    assert res["correct"] is False
    ex = res["checks"]["nucleus_excess"]
    assert ex["value"] > ex["limit"]
