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


@pytest.mark.parametrize("flag", [["--resume", "ckpt.msgpack"], ["--quant", "int8"],
                                  ["--tp", "2"], ["--spec-draft", "random"]])
def test_unported_flags_exit_nonzero(flag):
    with pytest.raises(SystemExit) as exc:
        lm_generate.main(SMALL + ["--prompt-tokens", "1,2", "-n", "2"] + flag)
    assert exc.value.code not in (0, None)
    assert "ROADMAP.md item A" in str(exc.value.code)


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
    with pytest.raises(SystemExit, match="--random-init"):
        lm_generate.main(argv)
