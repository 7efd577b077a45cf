"""The port's ``ServeEngine`` and ``launch/serve.py`` against the
reference, on the CPU.

The reference's termination cases (``tests/test_serve.py``) run on both
packages with the same stub model, written once per package: the ``out``
lists, ``done`` flags, ``decode_steps`` and metrics snapshots must be
equal. A greedy run of a reduced qwen2.5-3b with the reference's weights
carried across must give prefill logits within the whole-model bound of
``tests/test_torch_models.py`` and equal counters and streams; so must
greedy runs of a reduced granite-moe, mamba2 and zamba2. Both launchers
fail alike on whisper, whose frames neither engine passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import build_model as ref_build
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import convert
from repro_torch.configs import get_config as port_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

BOUND = 5e-2


class _RefStub:
    """The reference suite's stub: next token = (last + 1) mod V."""

    V = 16

    def prefill(self, params, batch, skv=None):
        last = batch["tokens"][:, -1]
        return jax.nn.one_hot((last + 1) % self.V, self.V), {"t": last}

    def decode_step(self, params, caches, batch):
        last = batch["tokens"][:, 0]
        return jax.nn.one_hot((last + 1) % self.V, self.V), caches


class _PortStub:
    """The same stub on torch tensors."""

    V = 16

    def prefill(self, params, batch, skv=None):
        last = batch["tokens"][:, -1].long()
        return torch.nn.functional.one_hot((last + 1) % self.V,
                                           self.V).float(), {"t": last}

    def decode_step(self, params, caches, batch):
        last = batch["tokens"][:, 0].long()
        return torch.nn.functional.one_hot((last + 1) % self.V,
                                           self.V).float(), caches


PACKAGES = {"ref": (_RefStub, RefEngine, RefRequest),
            "port": (_PortStub, ServeEngine, Request)}

# name: (engine kwargs, [(prompt, max_new_tokens, eos_id)])
CASES = {
    "eos_on_prefill_token": (dict(batch_slots=2), [([5], 8, 6)]),
    "eos_mid_stream": (dict(batch_slots=2), [([3], 10, 7)]),
    "partial_batch_padded_slots": (dict(batch_slots=4), [([1], 3, None)]),
    "mixed_eos_batch": (dict(batch_slots=2),
                        [([5], 8, 7), ([1], 4, None)]),
    "empty": (dict(batch_slots=2), []),
    "single_token": (dict(batch_slots=2), [([1, 2], 1, None)]),
    "max_seq_bound": (dict(batch_slots=2, max_seq=4), [([1, 2, 3], 10,
                                                        None)]),
    "several_batches": (dict(batch_slots=2),
                        [([1], 3, None), ([2, 3], 5, 6), ([9], 4, 12),
                         ([4, 4, 4], 2, None), ([15], 6, 3)]),
}


def _serve(pkg, kwargs, specs):
    stub, engine, request = PACKAGES[pkg]
    kwargs = dict(kwargs)
    eng = engine(stub(), {}, max_seq=kwargs.pop("max_seq", 32), **kwargs)
    reqs = [request(prompt=np.array(p, np.int32), max_new_tokens=n,
                    eos_id=e) for p, n, e in specs]
    got = eng.generate(reqs)
    assert got is reqs
    return ([r.out for r in reqs], [r.done for r in reqs],
            eng.decode_steps, eng.metrics.snapshot())


@pytest.mark.parametrize("case", sorted(CASES))
def test_termination_contract_matches_reference(case):
    kwargs, specs = CASES[case]
    assert _serve("port", kwargs, specs) == _serve("ref", kwargs, specs)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_generate_validates_before_running(pkg):
    stub, engine, request = PACKAGES[pkg]
    eng = engine(stub(), {}, max_seq=8, batch_slots=2)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.generate([request(prompt=np.arange(9, dtype=np.int32))])
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate([request(prompt=np.array([], np.int32))])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate([request(prompt=np.array([1], np.int32),
                              max_new_tokens=0)])
    assert eng.decode_steps == 0


def test_temperature_sampling_is_seeded_and_in_range():
    """At temperature > 0 the draw comes from the engine's generator:
    the same seed gives the same tokens, every token is in the vocab."""
    cfg = port_config("qwen2.5-3b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    outs = []
    for seed in (3, 3, 4):
        eng = ServeEngine(model, params, max_seq=32, batch_slots=2,
                          temperature=0.7, seed=seed)
        reqs = [Request(prompt=np.array([1, 2, 3], np.int32),
                        max_new_tokens=6) for _ in range(3)]
        eng.generate(reqs)
        outs.append([r.out for r in reqs])
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
        assert eng.metrics.counter("serve_tokens_sampled").total() == 18
    assert outs[0] == outs[1] and outs[0] != outs[2]


def _greedy_matches_reference(arch, n_requests):
    """A greedy run of the reduced ``arch`` with the reference's weights
    carried across, ``n_requests`` of ``launch/serve.py``'s prompts
    behind both packages' ``ServeEngine``: equal counters and streams,
    and the first batch's prefill logits within the whole-model bound."""
    cfg = get_config(arch).reduced()
    ref_model = ref_build(cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(port_config(arch).reduced())
    tp = model.load(convert.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(2, 12))
               .astype(np.int32) for _ in range(n_requests)]
    engines = {"ref": RefEngine(ref_model, params, max_seq=32,
                                batch_slots=4),
               "port": ServeEngine(model, tp, max_seq=32, batch_slots=4)}
    reqs = {"ref": [RefRequest(prompt=p, max_new_tokens=5)
                    for p in prompts],
            "port": [Request(prompt=p, max_new_tokens=5) for p in prompts]}
    for k, eng in engines.items():
        eng.generate(reqs[k])
    assert engines["port"].metrics.snapshot() == \
        engines["ref"].metrics.snapshot()
    assert engines["port"].decode_steps == engines["ref"].decode_steps
    assert [len(r.out) for r in reqs["port"]] == [5] * n_requests
    assert [r.out for r in reqs["port"]] == [r.out for r in reqs["ref"]]
    # the first batch's prefill, left-padded as the engine pads it
    toks = np.zeros((4, 11), np.int32)
    for i, p in enumerate(prompts[:4]):
        toks[i, 11 - len(p):] = p
    plen = max(len(p) for p in prompts[:4])
    toks = toks[:, 11 - plen:]
    want, _ = ref_model.prefill(params, {"tokens": jnp.asarray(toks)},
                                skv=32)
    got, _ = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, skv=32)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BOUND


def test_greedy_reduced_qwen_matches_reference():
    _greedy_matches_reference("qwen2.5-3b", 5)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-780m",
                                  "zamba2-2.7b"])
def test_greedy_reduced_family_matches_reference(arch):
    """The MoE, SSM and hybrid families behind both engines, the eight
    requests ``launch/serve.py`` sends (two batches of 11 and 8 tokens)."""
    _greedy_matches_reference(arch, 8)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ssm_batch_of_two_token_prompts_fails_in_both_packages(pkg):
    """An SSM prefill over fewer tokens than the conv window's three
    leaves a short conv cache, and the first decode step fails: the
    reference's behaviour, which the port keeps."""
    arch = "mamba2-780m"
    if pkg == "ref":
        model = ref_build(get_config(arch).reduced())
        params = model.init(jax.random.PRNGKey(0))
        eng = RefEngine(model, params, max_seq=16, batch_slots=2)
        req = RefRequest(prompt=np.array([1, 2], np.int32),
                         max_new_tokens=3)
    else:
        model = build_model(port_config(arch).reduced())
        eng = ServeEngine(model, model.init(0, device="cpu"), max_seq=16,
                          batch_slots=2)
        req = Request(prompt=np.array([1, 2], np.int32), max_new_tokens=3)
    with pytest.raises((ValueError, RuntimeError)):
        eng.generate([req])


def test_launch_serve_fails_on_whisper_as_the_reference_does(monkeypatch):
    """Neither package's engine passes whisper's frames (the reference
    engine sends only tokens): both launchers fail in the first prefill
    with the same ``KeyError``."""
    from repro.launch import serve as ref_launch
    argv = ["--arch", "whisper-small", "--requests", "2", "--max-new",
            "2", "--slots", "2"]
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with pytest.raises(KeyError, match="frames"):
        ref_launch.main()
    with pytest.raises(KeyError, match="frames"):
        launch_serve.main(argv + ["--device", "cpu"])


def test_launch_serve_runs_on_the_named_device(capsys):
    reqs = launch_serve.main(["--device", "cpu", "--requests", "3",
                              "--max-new", "2", "--slots", "2"])
    assert [len(r.out) for r in reqs] == [2, 2, 2]
    assert all(r.done for r in reqs)
    assert "6 tokens in" in capsys.readouterr().out
