"""The ``lm_train`` entry at a tiny Qwen2-shaped size on the CPU: the
program against its plain reference, the control and each fault a
training cell can have coming out as not correct, the frozen work counts,
the per-layer readers, and a second LM configuration and cell added as
files alone."""
import dataclasses
import json
import shutil

import pytest
import torch

import bench_testutil as tu
from pbench import faults, harness, lm_reference, work
from pbench.spec import Spec

CPU = torch.device("cpu")
LM = "qwen2_5_32b_stage4.train"
# Qwen2.5's shape at a size the CPU runs in a second
TINY = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_hidden_layers": 2, "vocab_size": 512}
SEQ = 32


@pytest.fixture(autouse=True)
def no_jax_look(monkeypatch):
    """The test process also runs the JAX package's tests (see
    test_bench_harness.py)."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tiny runs gain nothing from more, and the
    suite's workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny_cell(spec=None, name=LM, **config):
    cell = (spec or tu.spec()).cell(name)
    return dataclasses.replace(
        cell, config=dict(cell.config, **TINY, **config),
        traffic=dict(cell.traffic, seq_len=SEQ))


def _run(cell, program_cls=harness.Program, seed=2026_0034, trace=False,
         spec=None):
    return harness.run(cell, spec or tu.spec(), seed, 0.2, trace, CPU, 0.0,
                       program_cls)


@pytest.mark.parametrize("dtype, trace", [("bfloat16", False),
                                          ("float32", True)])
def test_the_program_agrees_with_its_reference(dtype, trace):
    """Off the card a traced run reads no per-layer metric."""
    res = _run(tiny_cell(torch_dtype=dtype), trace=trace)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == set(tu.spec().cell(LM).entry.NUMBERS)
    assert set(res["metrics"]) == (set() if trace else {"setup_s",
                                                        "step_s"})


def test_the_control_is_not_correct():
    """The reference with its products in fp8, in the program's place."""
    res = _run(tiny_cell(), program_cls=harness.Control)
    assert res["correct"] is False


@pytest.mark.parametrize("fault", ["step_unchanged", "half_batch",
                                   "answer"])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    """Each fault a one-chip plain-mean cell can have (pbench/faults.py);
    the exchange's is a secure cell's, below."""
    for mod, attr, fn in faults.FAULTS[fault]():
        monkeypatch.setattr(mod, attr, fn)
    res = _run(tiny_cell())
    assert res["correct"] is False and res["failed"] >= 1


def test_a_configuration_the_program_does_not_run_is_refused():
    with pytest.raises(ValueError, match="rms_norm_eps"):
        _run(tiny_cell(rms_norm_eps=1e-5))
    with pytest.raises(ValueError, match="reference"):
        _run(tiny_cell(arch="deepseek_v2_lite"))


def test_the_reference_follows_the_published_equations():
    """One layer by hand at a tiny size: the reference's loss is the
    cross-entropy of head(norm(x + ffn(norm(x + attn(norm(x)))))),
    attention head by head with its own key/value head."""
    m = lm_reference.Shape.of(dict(tiny_cell().config, num_hidden_layers=1))
    trainer = lm_reference.Trainer(m, {}, CPU)
    p, top = trainer.params["layers"][0], trainer.params
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for t in p.values():
            t.add_(0.1 * torch.randn(t.shape, generator=gen))
        tokens = torch.randint(0, m.vocab, (SEQ,), generator=gen)
        labels = torch.randint(0, m.vocab, (SEQ,), generator=gen)
        got = lm_reference.sequence_loss(top, tokens, labels, m)

        def norm(x, s):
            return x / torch.sqrt((x * x).mean(-1, keepdim=True)
                                  + m.eps) * (1 + s)

        def rope(x, i):
            half = m.head_dim // 2
            f = m.theta ** (-torch.arange(half) * 2.0 / m.head_dim)
            c, s = torch.cos(i * f), torch.sin(i * f)
            return torch.cat([x[:half] * c - x[half:] * s,
                              x[half:] * c + x[:half] * s])

        x = top["embed"][tokens]
        h = norm(x, p["ln1"])
        q, k, v = (h @ p["wq"] + p["bq"], h @ p["wk"] + p["bk"],
                   h @ p["wv"] + p["bv"])
        D, G = m.head_dim, m.heads // m.kv_heads
        out = torch.zeros(SEQ, m.heads * D)
        for hd in range(m.heads):
            kv = hd // G
            for i in range(SEQ):
                qi = rope(q[i, hd * D:(hd + 1) * D], i)
                ks = torch.stack([rope(k[j, kv * D:(kv + 1) * D], j)
                                  for j in range(i + 1)])
                w = torch.softmax(ks @ qi / D ** 0.5, dim=0)
                out[i, hd * D:(hd + 1) * D] = w @ v[:i + 1,
                                                    kv * D:(kv + 1) * D]
        x = x + out @ p["wo"]
        h = norm(x, p["ln2"])
        x = x + (torch.nn.functional.silu(h @ p["w3"]) * (h @ p["w1"])) \
            @ p["w2"]
        logits = norm(x, top["final_norm"]) @ top["lm_head"]
        want = torch.nn.functional.cross_entropy(logits, labels)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_frozen_attention_work_is_the_programs():
    from repro_torch.kernels import work as program_work

    args = (2, 4096, 40, 8, 128, 2)
    for name in ("k7_flash", "k8a_flash_dq", "k8b_flash_dkdv"):
        mine, theirs = getattr(work, name)(*args), getattr(program_work,
                                                            name)(*args)
        assert (mine.bytes, mine.bf16, mine.f32) == (
            theirs.bytes, theirs.bf16, theirs.f32)


def test_step_work_at_the_cells_shapes():
    cell = tu.spec().cell(LM)
    m = lm_reference.Shape.of(cell.config)
    # 4 layers of 487.6 M matmul parameters, the head's 97.3 M
    assert m.matmul_params() == 4 * 487_587_840 + 5120 * 19008
    pairs = 2 * 40 * 4096 * 4097 // 2
    k7 = cell.entry.attention_work(cell.config, cell.traffic)["K7"]
    assert k7.bf16 == pairs * 2 * 256
    assert cell.entry.step_flops(cell.config, cell.traffic) == (
        6 * m.matmul_params() * 16384 + 3 * k7.bf16 * 4 * 2)
    # the whole step at the bf16 peak: about 0.21 s
    assert 0.20 < cell.entry.step_flops(cell.config, cell.traffic) \
        / 989e12 < 0.22


def _ctx(cell, trace):
    from pbench import readers

    jobs = [{"seconds": 0.5}] * 80
    return readers.Context(cell.config, cell.traffic, True, 30.0, 40.0, jobs,
                           dict(trace, jobs=[{"seconds": 0.5}] * 4),
                           cell.entry)


def test_the_step_readers():
    cell = tu.spec().cell(LM)
    per = cell.entry.attention_work(cell.config, cell.traffic)
    least_us = sum(8 * w.least_s() for w in per.values()) * 4 * 1e6
    trace = {"by_category_us": {"K7 flash_attention": least_us / 2,
                                "K8a flash_dq": least_us / 4,
                                "K8b flash_dkdv": least_us / 4,
                                "matmul (cuBLAS)": 1.2e6, "small ops": 5e5,
                                "softmax / log_softmax": 1e5},
             "K7": 32, "K8a": 32, "K8b": 32, "busy_us": 3.6e6,
             "window_us": 4e6}
    read = tu.spec().reader
    ctx = _ctx(cell, trace)
    assert read("step_s")(ctx) == pytest.approx(0.5)
    assert read("attention_roofline.step")(ctx) == pytest.approx(100.0)
    assert read("matmul_ms.step")(ctx) == pytest.approx(300.0)
    assert read("small_ops_ms.step")(ctx) == pytest.approx(150.0)
    assert read("idle_share.step")(ctx) == pytest.approx(10.0)
    flops = 80 * cell.entry.step_flops(cell.config, cell.traffic)
    assert read("train_mfu.step")(ctx) == pytest.approx(
        100 * flops / 989e12 / 40.0)
    # nothing to read: no K7 launch, or a round's categories
    assert read("attention_roofline.step")(_ctx(cell, dict(trace,
                                                           K7=0))) is None
    assert read("small_ops_ms.step")(_ctx(cell, dict(
        trace, by_category_us={"K3": 1.0}))) is None


def _lm_checkout(tmp_path):
    """A checkout with a second LM configuration (tiny, Shamir-secure)
    and its cell: new files and new BENCHMARK.json entries alone."""
    root = tmp_path / "checkout"
    shutil.copytree(tu.BENCH, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tu.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((tu.BENCH / "configs"
                      / "qwen2_5_32b_stage4.json").read_text())
    cfg.update(TINY, name="tiny_lm_s3", institutions=3,
               secure_agg="shamir", threshold=2, centers=3,
               moduli=[2147483647, 2147483629], frac_bits=28)
    (root / "port_bench" / "configs" / "tiny_lm_s3.json").write_text(
        json.dumps(cfg))
    mix = json.loads((tu.BENCH / "traffic" / "train.json").read_text())
    mix.update(batch=2, seq_len=SEQ)
    (root / "port_bench" / "traffic" / "train_short.json").write_text(
        json.dumps(mix))
    (root / "port_bench" / "limits" / "tiny_lm_s3.train_short.json"
     ).write_text((tu.BENCH / "limits" / f"{LM}.json").read_text())
    bench["configs"].append({"name": "tiny_lm_s3", "source": "a test",
                             "file": "port_bench/configs/tiny_lm_s3.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_lm_s3.train_short",
                               "config": "tiny_lm_s3",
                               "traffic": "train_short", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if LM in m.get("workloads", ()):
            m["workloads"].append("tiny_lm_s3.train_short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(root)


def test_a_second_lm_cell_is_added_by_files_alone(tmp_path, monkeypatch):
    spec = _lm_checkout(tmp_path)
    cell = spec.cell("tiny_lm_s3.train_short")
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "step_s"]
    assert len(cell.per_layer) == 5
    res = _run(cell, spec=spec)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"setup_s", "step_s"}
    for mod, attr, fn in faults.FAULTS["exchange"]():
        monkeypatch.setattr(mod, attr, fn)
    assert _run(cell, spec=spec)["correct"] is False
