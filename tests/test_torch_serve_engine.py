"""The port's ``ServeEngine`` and ``launch/serve.py`` against the
reference, on the CPU.

The reference's termination cases (``tests/test_serve.py``) run on both
packages with the same stub model, written once per package: the ``out``
lists, ``done`` flags, ``decode_steps`` and metrics snapshots must be
equal. A greedy run of a reduced qwen2.5-3b with the reference's weights
carried across must give prefill logits within the whole-model bound of
``tests/test_torch_models.py`` and equal counters and streams; so must
greedy runs of a reduced granite-moe, mamba2 and zamba2.

Two faults of the reference's serving path are repaired in the port and
still shown in the reference: whisper's frames, which the reference's
engine never passes (the port's requests carry them, and its greedy
tokens equal the reference's ``Model.prefill`` and ``decode_step``
driven by hand on the same weights and frames), and SSM prompts shorter
than the conv window, whose short cache makes the reference's first
decode step raise (the port serves them, each step within the
decode-vs-forward bound of its forward, through ``chip_smoke.py``'s
phase-13 helper). ``launch/serve.py``'s ``--no-reduced`` serves the
published config.
"""

import importlib.util
import os

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
SELF_BOUND = 1e-1           # decode vs forward (tests/test_models.py)


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()


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


def _reduced(arch):
    """The reduced ``arch``: the reference's model and its weights from
    ``PRNGKey(0)``, the port's model holding them."""
    cfg = get_config(arch).reduced()
    ref_model = ref_build(cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(port_config(arch).reduced())
    tp = model.load(convert.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    return ref_model, params, model, tp


def _greedy_matches_reference(arch, n_requests):
    """A greedy run of the reduced ``arch`` with the reference's weights
    carried across, ``n_requests`` of ``launch/serve.py``'s prompts
    behind both packages' ``ServeEngine``: equal counters and streams,
    and the first batch's prefill logits within the whole-model bound."""
    ref_model, params, model, tp = _reduced(arch)
    cfg = ref_model.cfg
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


def test_ssm_batch_of_two_token_prompts_fails_in_the_reference():
    """An SSM prefill over fewer tokens than the conv window's three
    leaves the reference a short conv cache, and its first decode step
    raises (the port's case is ``test_port_serves_short_ssm_prompts``)."""
    model = ref_build(get_config("mamba2-780m").reduced())
    eng = RefEngine(model, model.init(jax.random.PRNGKey(0)), max_seq=16,
                    batch_slots=2)
    with pytest.raises((ValueError, RuntimeError)):
        eng.generate([RefRequest(prompt=np.array([1, 2], np.int32),
                                 max_new_tokens=3)])


@pytest.mark.parametrize("plen", [1, 2])
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-2.7b"])
def test_port_serves_short_ssm_prompts(arch, plen):
    """Two greedy requests of ``plen`` tokens behind the port's engine
    (the reference's weights): the prefill and each of three decode steps
    within the decode-vs-forward bound of the forward over the prompt and
    the tokens generated so far. zamba2's reduced stack is chaotic at
    this init (the reference's own decode reads 0.41 from its forward,
    the port's unforced steps here up to 0.55), so its shared attention's
    prefill and decode cores are fed the forward's rows, as the card
    holds it (``chip_smoke.HARD_ATTENTION``), their inputs held within
    ``BOUND`` of the forward's."""
    _, _, model, tp = _reduced(arch)
    hard = arch in CHIP_SMOKE.HARD_ATTENTION
    got = CHIP_SMOKE.short_prompt_serve(torch, model, tp, plen, "cpu", hard)
    assert len(got["held"]) == 4
    assert max(got["held"]) < SELF_BOUND
    assert got.get("forced_inputs_worst", 0.0) <= BOUND
    if not hard:
        assert got["held"] == got["decode_vs_forward"]


def test_launch_serve_fails_on_whisper_in_the_reference(monkeypatch):
    """The reference's engine passes only tokens, so its launcher fails on
    whisper in the first prefill (the port's case is
    ``test_port_serves_whisper``)."""
    from repro.launch import serve as ref_launch
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "whisper-small",
                                     "--requests", "2", "--max-new", "2",
                                     "--slots", "2"])
    with pytest.raises(KeyError, match="frames"):
        ref_launch.main()


def _ref_by_hand(model, params, reqs, slots, max_seq):
    """The reference's ``Model.prefill`` and ``decode_step`` driven by
    hand as the engine drives them: ``slots`` requests a batch, prompts
    left-padded, frames stacked (a padded slot's zero), greedy."""
    cfg = model.cfg
    outs = []
    for lo in range(0, len(reqs), slots):
        part = reqs[lo:lo + slots]
        plen = max(len(r.prompt) for r in part)
        toks = np.zeros((slots, plen), np.int32)
        frames = np.zeros((slots, cfg.n_frames, cfg.d_model), np.float32)
        for i, r in enumerate(part):
            toks[i, plen - len(r.prompt):] = r.prompt
            frames[i] = r.frames
        logits, caches = model.prefill(params, {
            "tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
            skv=max_seq)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        pos = jnp.full((slots,), plen, jnp.int32)
        seq = [tok]
        for _ in range(max(r.max_new_tokens for r in part) - 1):
            logits, caches = model.decode_step(
                params, caches, {"tokens": tok[:, None], "pos": pos})
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            pos = pos + 1
            seq.append(tok)
        outs += np.stack([np.asarray(t) for t in seq], 1)[:len(part)] \
            .tolist()
    return outs


@pytest.mark.parametrize("entry", ["launch.serve", "ServeEngine"])
def test_port_serves_whisper(entry, capsys):
    """The reduced whisper served greedily, three requests over two slots
    (the second batch with a padded slot): through ``launch/serve.py``
    (its frames drawn after its prompts) and through ``ServeEngine``
    (frames from another seed), the tokens equal the reference's
    ``Model.prefill`` and ``decode_step`` driven by hand on the same
    weights and frames."""
    ref_model, params, model, tp = _reduced("whisper-small")
    if entry == "launch.serve":
        reqs = launch_serve.main(
            ["--arch", "whisper-small", "--device", "cpu", "--requests",
             "3", "--slots", "2", "--max-new", "5", "--max-seq", "32",
             "--temperature", "0"], params=tp)
        assert "15 tokens in" in capsys.readouterr().out
    else:
        rng = np.random.default_rng(7)
        cfg = model.cfg
        reqs = [Request(prompt=rng.integers(0, cfg.vocab, n).astype(
                    np.int32), max_new_tokens=5,
                    frames=rng.standard_normal((cfg.n_frames, cfg.d_model))
                    .astype(np.float32)) for n in (3, 7, 1)]
        ServeEngine(model, tp, max_seq=32, batch_slots=2).generate(reqs)
    assert all(r.frames is not None and r.done for r in reqs)
    want = _ref_by_hand(ref_model, params, reqs, 2, 32)
    assert [r.out for r in reqs] == want


FRAMES_CASES = {
    "enc_dec_without_frames": ("whisper-small", None, "needs Request.frames"),
    "enc_dec_wrong_shape": ("whisper-small", (3, 64), "has shape"),
    "decoder_only_with_frames": ("qwen2.5-3b", (24, 64), "takes no frames"),
}


@pytest.mark.parametrize("case", sorted(FRAMES_CASES))
def test_frames_are_checked_before_any_prefill(case):
    """An encoder-decoder request without frames (or of another shape),
    and frames given to a decoder-only model, raise ``ValueError`` naming
    the field before anything runs."""
    arch, shape, match = FRAMES_CASES[case]
    model = build_model(port_config(arch).reduced())
    eng = ServeEngine(model, model.init(0, device="cpu"), max_seq=16,
                      batch_slots=2)
    frames = None if shape is None else np.zeros(shape, np.float32)
    req = Request(prompt=np.array([1, 2, 3], np.int32), frames=frames)
    with pytest.raises(ValueError, match=match):
        eng.generate([req])
    assert eng.decode_steps == 0 and req.out == []


@pytest.mark.parametrize("flags,reduced", [([], True), (["--reduced"], True),
                                           (["--no-reduced"], False)])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-small"])
def test_launch_serve_reduced_flag(arch, flags, reduced):
    """``--reduced`` stays the default and ``--no-reduced`` serves the
    published config; nothing is built to tell."""
    cfg = launch_serve.config_of(launch_serve.parse_args(
        ["--arch", arch] + flags))
    published = port_config(arch)
    assert cfg == (published.reduced() if reduced else published)


def test_launch_serve_runs_on_the_named_device(capsys):
    reqs = launch_serve.main(["--device", "cpu", "--requests", "3",
                              "--max-new", "2", "--slots", "2"])
    assert [len(r.out) for r in reqs] == [2, 2, 2]
    assert all(r.done for r in reqs)
    assert "6 tokens in" in capsys.readouterr().out
