"""Port's lm_generate recipe on the CPU: flag surface, output, refusals."""

import pytest

from pytorch_distributed_tpu_torch.recipes import lm_generate

SMALL = ["--device", "cpu", "--random-init", "--vocab", "256", "--d-model", "32",
         "--n-heads", "4", "--n-layers", "2"]


def test_random_init_greedy_prints_tokens(capsys):
    assert lm_generate.main(SMALL + ["--prompt", "hi", "-n", "5"]) == 0
    out = capsys.readouterr().out
    tokens = [line for line in out.splitlines() if line.startswith("tokens: ")]
    assert len(tokens) == 1 and len(eval(tokens[0][len("tokens: "):])) == 5
    assert "text: 'hi" in out


def test_sampling_flags_are_seeded(capsys):
    argv = SMALL + ["--prompt-tokens", "1,2,3", "-n", "6", "--temperature", "1.3",
                    "--top-k", "20", "--top-p", "0.9", "--precision", "bf16"]
    assert lm_generate.main(argv + ["--seed", "4"]) == 0
    first = capsys.readouterr().out
    assert lm_generate.main(argv + ["--seed", "4"]) == 0
    assert capsys.readouterr().out == first


@pytest.mark.parametrize("flag,error,message", [
    (["--tp", "2", "--spec-draft", "random"], SystemExit,
     "--spec-draft is batch-1 single-device serving; it does not compose with --tp"),
    (["--tp", "2", "--quant", "int8"], ValueError, r"mesh shape \(2,\) != device count 1")])
def test_unported_flags_exit_nonzero(flag, error, message):
    """``--tp`` is ported (``tests/test_torch_lm_mesh.py`` runs it at two
    ranks); what still stops a run: the JAX refusal of speculation under
    ``--tp``, and ``--tp 2`` without a launcher's second rank (the JAX mesh
    error on one device)."""
    with pytest.raises(error, match=message):
        lm_generate.main(SMALL + ["--prompt-tokens", "1,2", "-n", "2"] + flag)


@pytest.mark.parametrize("argv", [
    ["--prompt-tokens", "1,999"],                     # out of the vocab
    ["--prompt", ""],                                 # no prompt at all
])
def test_bad_prompts_exit_nonzero(argv):
    with pytest.raises(SystemExit) as exc:
        lm_generate.main(SMALL + argv)
    assert exc.value.code not in (0, None)


def test_needs_random_init():
    argv = [a for a in SMALL if a != "--random-init"] + ["--prompt-tokens", "1"]
    with pytest.raises(SystemExit, match=r"--resume CHECKPOINT \(or --random-init\)"):
        lm_generate.main(argv)
