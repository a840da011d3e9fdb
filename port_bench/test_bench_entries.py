"""The kinds of job as modules (``port_bench/entries/``): the
logistic-regression cells read through their entry modules what the
harness read before it had them, and a mix whose entry has no module is
refused."""
import json
import shutil

import pytest
import torch

import bench_testutil as tu
from pbench import harness
from pbench.spec import Spec

CPU = torch.device("cpu")
SEED = 20260417
# the harness before entry modules (one job a λ, seeds and fold seeds;
# rounds; the sampled jobs; the comparison's numbers), at tu.TINY and SEED,
# on the CPU: (λ or None, seed, fold seed or None) a window job
PARENT = {
    "pascal_alpha_s8.fit": {
        "jobs": [(4.393970560760792, 3920244587992804675, None),
                 (11.787686347935873, 2379497973865557554, None),
                 (0.22758459260747887, 2504556680175662441, None),
                 (0.6105402296585329, 4078847035834482086, None),
                 (31.622776601683793, 801640766515547033, None),
                 (1.6378937069540647, 900115998744892762, None),
                 (0.03162277660168379, 301290889502546706, None),
                 (0.08483428982440726, 3255381338953116050, None),
                 (0.22758459260747887, 3575897190662461792, None),
                 (0.08483428982440726, 1243207178563868425, None)],
        "warm": (31.622776601683793, 2408015788873018619, None),
        "rounds": [7, 7, 7, 7, 6, 7, 7, 7, 7, 7],
        "sample": [0, 1, 3, 4, 5, 6, 8, 9],
        "checks": {"beta_gap": 4.814400745444703e-11,
                   "obj_gap": 6.235037963563733e-12, "unconverged": 0,
                   "wire_mismatch": 0}},
    "higgs_s8.fit": {
        "jobs": [(4.393970560760792, 3920244587992804675, None),
                 (11.787686347935873, 2379497973865557554, None),
                 (0.22758459260747887, 2504556680175662441, None),
                 (0.6105402296585329, 4078847035834482086, None),
                 (31.622776601683793, 801640766515547033, None),
                 (1.6378937069540647, 900115998744892762, None),
                 (0.03162277660168379, 301290889502546706, None),
                 (0.08483428982440726, 3255381338953116050, None),
                 (0.22758459260747887, 3575897190662461792, None)],
        "warm": (31.622776601683793, 2408015788873018619, None),
        "rounds": [6, 6, 6, 6, 6, 6, 7, 7, 6],
        "sample": [0, 1, 3, 4, 5, 6, 7, 8],
        "checks": {"beta_gap": 3.180141760740399e-10,
                   "obj_gap": 4.76106092539438e-12, "unconverged": 0,
                   "wire_mismatch": 0}},
    "pascal_alpha_s8.path": {
        "jobs": [(None, 569797324736751635, 561040227),
                 (None, 2372208959603728991, 1541170115)],
        "warm": (None, 4098408972010076550, 1839061031),
        "rounds": [(39, 35, 4), (39, 35, 4)],
        "sample": [0, 1],
        "checks": {"count_mismatch": 0, "pick_mismatch": 0,
                   "refit_gap": 2.815900007610095e-11,
                   "vdev_gap": 5.2302563920916535e-11,
                   "wire_mismatch": 0}},
}
# pascal_alpha_s8's parts at tu.TINY and SEED: each one's sum of X, of y
PARTS = ([14.276336951478758, 10.16719183920633, 10.687865758229883,
          5.889645408669834, 11.213540929785703, -41.916132063193885,
          -17.38032181756143, -19.19571502610765],
         [65.0, 70.0, 67.0, 74.0, 78.0, 79.0, 78.0, 72.0])


def _key(job):
    return (job.get("lam"), job["seed"], job.get("fold_seed"))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tiny runs gain nothing from more, and the
    suite's workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", sorted(PARENT))
def test_a_logistic_cell_reads_what_the_parent_harness_read(name):
    want = PARENT[name]
    cell = tu.tiny_cell(name)
    setup = harness.Setup(cell, SEED, CPU)
    answers, records, _ = setup.run_jobs(count=len(want["jobs"]))
    setup.free()
    assert [_key(j) for j, _ in setup.warm] == [want["warm"]]
    assert [_key(j) for j, _ in answers] == want["jobs"]
    rounds = [r["rounds"] if "sweep_rounds" not in r else
              (r["rounds"], r["sweep_rounds"], r["refit_rounds"])
              for r in records]
    assert rounds == want["rounds"]
    assert cell.entry.sample(answers, cell.traffic, SEED) == want["sample"]
    correct, checks, failed = harness.check(cell, setup.inputs, answers,
                                            SEED, setup.warm)
    assert correct and failed == 0
    assert {k: c["value"] for k, c in checks.items()} == pytest.approx(
        want["checks"], rel=1e-6)
    if name.startswith("pascal"):
        assert [float(X.sum()) for X, _ in setup.inputs] == pytest.approx(
            PARTS[0], rel=1e-12)
        assert [float(y.sum()) for _, y in setup.inputs] == PARTS[1]


def test_a_mix_whose_entry_has_no_module_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(tu.BENCH, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tu.ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((tu.BENCH / "traffic" / "fit.json").read_text())
    for entry in ("no_such_kind", "../pbench/harness"):
        mix["entry"] = entry
        (root / "port_bench" / "traffic" / "odd.json").write_text(
            json.dumps(mix))
        (root / "port_bench" / "limits" / "higgs_s8.odd.json").write_text(
            (tu.BENCH / "limits" / "higgs_s8.fit.json").read_text())
        bench["workloads"] = [{"name": "higgs_s8.odd", "config": "higgs_s8",
                               "traffic": "odd", "chips": 1, "why": "a test"}]
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        with pytest.raises(ValueError, match="has no module"):
            Spec(root).cell("higgs_s8.odd")
