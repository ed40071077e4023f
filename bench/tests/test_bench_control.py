"""The control comes out not correct: the plain reference computed at TF32
in the program's place (``--control 1``: at every served position the
token the TF32 reference puts first, judged by the f32 reference) goes
through the harness's own verdict and fails the limit that the program's
own run keeps, on a CPU-sized cell whose vocabulary (4096) is wide enough
for TF32's error to reorder its top logits."""
import pytest

pytest.importorskip("torch")

import tinycell  # noqa: E402


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_tf32_control_fails_the_limit(tmp_path, capsys, seed):
    cfg = tinycell.config(False, vocab_size=4096, hidden_size=128,
                          num_hidden_layers=4)
    res = tinycell.run_cell(tinycell.make_root(tmp_path, cfg), capsys,
                            seed=seed, control=1)
    control = res["checks"]["logit_gap"]
    program = res["checks"]["program_logit_gap"]
    assert res["correct"] is False
    assert control["value"] > control["limit"]
    assert program["limit"] is None
    assert program["value"] <= control["limit"]
    assert control["value"] > 3 * max(program["value"], 1e-6)
