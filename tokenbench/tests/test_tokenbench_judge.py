"""The judge of a routed model, on the CPU at smoke size: the reference's
route margins, the verdict over the decided tokens, the split-K witness,
the fp8 control, and the faults of a router that must turn ``correct``
false while near-tie flips leave it true."""
import json
import time

import pytest
import torch

from tokenbench import harness, model
from tokenbench.reference import check
from tokenbench.reference.decoder import Reference
from tokenbench.tests.smoke import BENCH, SMOKE, run_smoke

# the smoke MoE cell's route margin, in router logits: at 0.1 the decided
# tokens are about three quarters of those judged (CPU readings over
# three seeds); the served tokens and the witness read at most 0.02 over
# them, the fp8 control at least 0.38
SMOKE_MARGIN = 0.1


def _parent_verdict(gaps, lim):
    """The verdict as it was before route margins: every token judged."""
    widest = float(gaps.max()) if len(gaps) else None
    checks = {
        "tokens_judged": {"value": int(len(gaps)),
                          "limit": lim["tokens_judged"]},
        "logit_gap_max": {"value": widest, "limit": lim["logit_gap_max"]},
    }
    correct = (widest is not None and widest <= lim["logit_gap_max"]
               and len(gaps) >= lim["tokens_judged"])
    return bool(correct), checks


@pytest.mark.parametrize("gaps", [
    [], [0.0] * 3, [0.01, 0.2, 0.05], [0.01] * 20, [0.01] * 19 + [0.7],
    [0.6] * 20])
@pytest.mark.parametrize("routed", [False, True])
def test_verdict_without_route_margin_is_the_parents(gaps, routed):
    g = torch.tensor(gaps, dtype=torch.float32)
    lim = {"logit_gap_max": 0.6, "tokens_judged": 10}
    margins = torch.linspace(0, 0.2, len(gaps)) if routed else None
    assert harness.verdict(g, lim, margins) == _parent_verdict(g, lim)
    assert harness.verdict(g, lim) == _parent_verdict(g, lim)


def test_verdict_judges_decided_tokens_only():
    g = torch.tensor([0.9, 0.01, 0.02, 0.8])
    m = torch.tensor([0.01, 0.3, 0.05, 0.049])
    lim = {"logit_gap_max": 0.6, "tokens_judged": 2, "route_margin": 0.05}
    correct, checks = harness.verdict(g, lim, m)
    assert correct is True
    assert checks == {"tokens_judged": {"value": 2, "limit": 2},
                      "logit_gap_max": {"value": pytest.approx(0.02),
                                        "limit": 0.6}}
    # a decided token over the limit fails, whatever the near ties read
    g[1] = 0.61
    assert harness.verdict(g, lim, m)[0] is False
    # a dense model has no margins: every token is judged
    assert harness.verdict(g, lim)[1]["tokens_judged"]["value"] == 4


def _shapes(src, **extra):
    spec = json.loads((BENCH / "configs" / f"{src}.json").read_text())
    spec["config"].update(SMOKE, **extra)
    s = model.shapes(spec)
    return s, model.make_params(s, 2**31 + 11, "cpu")


def test_reference_margins_are_the_routers_smallest():
    s, p = _shapes("mixtral-8x22b.l12", num_local_experts=4)
    k = s["top_k"]
    per_layer = []

    class Recorded(Reference):
        def ffn(self, lp, x):
            top = (x.float() @ lp["wr"]).sort(-1, descending=True).values
            per_layer.append(top[:, k - 1] - top[:, k])
            return super().ffn(lp, x)

    toks = torch.randint(0, s["vocab"], (90,),
                         generator=torch.Generator().manual_seed(1)).tolist()
    rows = list(range(40, 90))
    lg, margin = Recorded(s, p).logits(toks, rows)
    assert len(per_layer) == s["layers"]
    want = torch.stack(per_layer).min(0).values[rows]
    assert torch.equal(margin, want)
    assert (margin >= 0).all() and lg.shape == (len(rows), s["vocab"])
    # the control and the witness read the same positions
    for kw in ({"quant": "fp8"}, {"order": "splitk"}):
        assert Reference(s, p, **kw).logits(toks, rows)[0].shape == lg.shape
    sd, pd = _shapes("qwen2.5-14b")
    assert Reference(sd, pd).logits(toks, rows)[1] is None


def test_splitk_sums_two_float32_halves():
    s, p = _shapes("qwen2.5-14b")
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(2)
                    ).to(torch.bfloat16)
    w = p["layers"]["wq"][0][:64]
    want = x[:, :32].float() @ w[:32].float() \
        + x[:, 32:].float() @ w[32:].float()
    got = Reference(s, p, order="splitk").mm(x, w)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    torch.testing.assert_close(got.double(), x.double() @ w.double(),
                               rtol=2**-8, atol=1e-6)
    with pytest.raises(ValueError, match="accumulation order"):
        Reference(s, p, order="splitq")


# -- the routed rule over served runs --------------------------------------

@pytest.fixture
def routed(smoke):
    """The smoke benchmark with the MoE cell judged by its route margin."""
    root, tb = smoke
    path = tb / "cells" / "moe.mini.json"
    cell = json.loads(path.read_text())
    cell["limits"]["route_margin"] = SMOKE_MARGIN
    path.write_text(json.dumps(cell))
    return root, tb


def _serve(root, tb, cell="moe.mini", seed=2**31 + 7):
    return harness.serve(harness.Bench(root, tb), cell, seed, 4.0, False,
                         time.perf_counter(), device="cpu",
                         log=lambda m: None)


def test_port_and_witness_are_correct_and_the_control_is_not(routed):
    run = _serve(*routed)
    quiet = lambda m: None  # noqa: E731
    port, port_checks = harness.judge(run, quiet)
    wit, wit_checks = harness.judge(run, quiet, control="splitk")
    ctl, ctl_checks = harness.judge(run, quiet, control="fp8")
    assert port is True and wit is True and ctl is False
    # one reference pass reads every side as the judge reads it alone
    gaps, margins, seconds = harness.readings(run, quiet, (None, "splitk",
                                                            "fp8"))
    assert len(seconds) == len(run.items) and min(seconds) > 0
    for side, checks in ((None, port_checks), ("splitk", wit_checks),
                         ("fp8", ctl_checks)):
        assert harness.verdict(gaps[side], run.dep["limits"],
                               margins) == (side is None or side == "splitk",
                                            checks)
    gaps = gaps[None]
    decided = int((margins >= SMOKE_MARGIN).sum())
    assert 10 <= decided < len(gaps)
    for checks in (port_checks, wit_checks, ctl_checks):
        assert checks["tokens_judged"]["value"] == decided
    lim = port_checks["logit_gap_max"]["limit"]
    assert ctl_checks["logit_gap_max"]["value"] > lim
    assert port_checks["logit_gap_max"]["value"] * 3 < \
        ctl_checks["logit_gap_max"]["value"]


def test_the_dense_witness_is_correct(smoke):
    run = _serve(*smoke, cell="dense.mini")
    assert harness.judge(run, lambda m: None, control="splitk")[0] is True


def test_too_few_decided_tokens_is_not_correct(routed):
    run = _serve(*routed)
    gaps, margins, _ = harness.readings(run, lambda m: None)
    gaps = gaps[None]
    decided = int((margins >= SMOKE_MARGIN).sum())
    lim = dict(run.dep["limits"], tokens_judged=decided)
    assert harness.verdict(gaps, lim, margins)[0] is True
    lim["tokens_judged"] = decided + 1
    assert harness.verdict(gaps, lim, margins)[0] is False
    assert harness.verdict(gaps, dict(lim, route_margin=1.0),
                           margins)[0] is False


def test_a_token_altered_at_a_decided_position_is_not_correct(routed):
    run = _serve(*routed)
    res = check.gaps(run.shapes, run.params, run.items)
    i, j = next((i, int(j)) for i, (_, m, _) in enumerate(res)
                for j in torch.nonzero(m >= SMOKE_MARGIN)[:, 0])
    served = run.items[i][1]
    served[j] = (served[j] + 1) % run.shapes["vocab"]
    correct, checks = harness.judge(run, lambda m: None)
    assert correct is False
    assert checks["logit_gap_max"]["value"] > \
        checks["logit_gap_max"]["limit"]


def _route(monkeypatch, pick):
    """The port's router with ``pick(logits, k)`` -> (gates, experts) in
    place of its top-k of the softmax with renormalised gates."""
    from repro_torch.models import moe

    def route(cfg, lp, xt, valid=None):
        e, k = cfg.num_experts, cfg.experts_per_token
        logits = xt.float() @ lp["wr"]
        gate, idx = pick(logits, k)
        flat_e = idx.reshape(-1)
        if valid is not None:
            flat_e = torch.where(valid[:, None].expand(-1, k).reshape(-1),
                                 flat_e, e)
            gate = gate * valid.float()[:, None]
        return logits, torch.softmax(logits, -1), gate, flat_e
    monkeypatch.setattr(moe, "route", route)


def _renormalised(gate, idx):
    return gate / gate.sum(-1, keepdim=True), idx


def _ranked_2_and_3(logits, k):
    gate, idx = torch.topk(torch.softmax(logits, -1), k + 1, dim=-1)
    return _renormalised(gate[:, 1:], idx[:, 1:])


def _not_renormalised(logits, k):
    return torch.topk(torch.softmax(logits, -1), k, dim=-1)


@pytest.mark.parametrize("pick", [_ranked_2_and_3, _not_renormalised])
def test_a_broken_router_is_not_correct(routed, monkeypatch, pick):
    _route(monkeypatch, pick)
    out = run_smoke(*routed, "moe.mini")
    assert out["correct"] is False
    assert out["checks"]["logit_gap_max"]["value"] > \
        out["checks"]["logit_gap_max"]["limit"]


def test_near_tie_flips_leave_the_run_correct(routed, monkeypatch):
    """Noise on the port's router logits, at most a quarter of the route
    margin either way, so that only routes whose top-k is decided by
    under half the margin can flip."""
    gen = torch.Generator().manual_seed(5)
    flips = []

    def noisy(logits, k):
        n = logits + SMOKE_MARGIN / 2 * (
            torch.rand(logits.shape, generator=gen) - 0.5)
        clean = torch.topk(logits, k, dim=-1).indices.sort(-1).values
        gate, idx = torch.topk(torch.softmax(n, -1), k, dim=-1)
        flips.append(int((idx.sort(-1).values != clean).any(-1).sum()))
        return _renormalised(gate, idx)
    _route(monkeypatch, noisy)
    out = run_smoke(*routed, "moe.mini")
    assert sum(flips) > 0
    assert out["correct"] is True


def test_calibrate_control_reads_three_sides(routed):
    from tokenbench import calibrate
    run = _serve(*routed)
    out = calibrate.sides(run, [0.01, SMOKE_MARGIN], lambda m: None)
    assert set(out) == {"served", "witness", "control", "sample", "tokens"}
    gaps, margins, _ = harness.readings(run, lambda m: None)
    gaps = gaps[None]
    n = len(gaps)
    tokens = torch.tensor(out["tokens"])
    assert tokens.shape == (n, 4)
    torch.testing.assert_close(tokens[:, 0], margins, atol=1e-5, rtol=0)
    torch.testing.assert_close(tokens[:, 1], gaps, atol=1e-5, rtol=0)
    for side in ("served", "witness", "control"):
        r = out[side]
        assert r["every"]["tokens"] == n
        d = r["decided"][str(SMOKE_MARGIN)]
        assert d["tokens"] == r["checks"]["tokens_judged"]["value"]
        assert 0 < d["share"] < 1
        assert r["decided"]["0.01"]["tokens"] >= d["tokens"]
    assert out["served"]["correct"] and out["witness"]["correct"]
    assert not out["control"]["correct"]
    assert [row[0] for row in out["sample"]] == \
        [len(served) for _, served in run.items]
    assert all(row[2] > 0 for row in out["sample"])
    assert int((tokens[:, 0] >= SMOKE_MARGIN).sum()) == \
        out["served"]["decided"][str(SMOKE_MARGIN)]["tokens"]
