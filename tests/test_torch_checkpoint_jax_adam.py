"""Checkpoints between the JAX engine and the PyTorch port under Adam's
per-tensor form: GPT-2 with 11 layers, ZeRO 0 on one device and ZeRO 1 on
the suite's 8-device mesh. The round trip and its tolerance are
``tests/test_torch_checkpoint_jax.py``'s (``cross_engines``): the JAX
engine's tag into the port, the port's tag back into the JAX engine,
losses and params at rtol = atol = 1e-5 against the other engine's own
continuation. The moments travel as one ``.mu[...]`` / ``.nu[...]`` leaf
a parameter, in the flax layout.
"""

from tests.test_torch_checkpoint_jax import STAGES, _one_thread, \
    cross_engines  # noqa: F401 (the module fixture)


@STAGES
def test_adam_tags_cross_between_engines(tmp_path, monkeypatch, stage, ndev):
    cross_engines(tmp_path, monkeypatch, "gpt2", "adam", stage, ndev)
