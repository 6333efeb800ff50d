"""The graph draw: the published counts of distinct triples, fitted to the
real held-out triples, and every seed the same structure under other
labels."""
import numpy as np
import pytest

from portbench import graphs, harness

TRAFFIC = {name: harness.load_json(harness.HERE / "traffic" / f"{name}.json")
           for name in ("fb15k237.train", "wn18.train")}
TOY = {"sample": "toy", "n_entities": 16, "n_relations": 9, "n_train": 43,
       "structure_seed": 0}


def test_samples_are_the_held_out_splits():
    """The frozen samples hold the datasets' valid and test counts."""
    for name, (valid, test) in {"fb15k237": (17535, 20466),
                                "wn18": (5000, 5000), "toy": (5, 5)}.items():
        got = graphs.load_sample(name)
        assert (len(got["valid"]), len(got["test"])) == (valid, test)


def test_smoothed_spreads_the_missing_mass():
    p = graphs.smoothed(np.array([3, 1, 0, 0]))
    # one category seen once in 4: a quarter of the mass goes to the two
    # unseen ones
    assert p.tolist() == pytest.approx([0.75 * 3 / 4, 0.75 / 4, 0.125,
                                        0.125])
    assert graphs.smoothed(np.array([2, 2])).tolist() == [0.5, 0.5]
    assert graphs.unseen_share(np.array([5, 5, 7])) == pytest.approx(1 / 3)
    assert graphs.unseen_share(np.array([], dtype=np.int64)) == 1.0


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_draw_keeps_the_samples_mix(name):
    """Distinct train triples of the published count whose relation
    shares follow the sample's (total variation under 5 %) and whose
    busiest entity's share of endpoints lies within 30 % of the
    sample's."""
    traffic = TRAFFIC[name]
    g = graphs.draw(traffic, 3)
    t = g["train"]
    assert t.shape == (traffic["n_train"], 3)
    ne, nr = traffic["n_entities"], traffic["n_relations"]
    key = (t[:, 0].astype(np.int64) * nr + t[:, 1]) * ne + t[:, 2]
    assert len(np.unique(key)) == len(t)
    held = np.concatenate([g["valid"], g["test"]])

    def shares(x, n):
        return np.bincount(x, minlength=n) / len(x)
    assert 0.5 * np.abs(shares(t[:, 1], nr)
                        - shares(held[:, 1], nr)).sum() < 0.05
    top = [shares(np.concatenate([x[:, 0], x[:, 2]]), ne).max()
           for x in (t, held)]
    assert abs(top[0] / top[1] - 1) < 0.3


def degrees(column, n):
    return sorted(np.bincount(column, minlength=n).tolist())


@pytest.mark.parametrize("traffic", [TRAFFIC["wn18.train"], TOY])
def test_seeds_relabel_one_structure(traffic):
    a = graphs.draw(traffic, 1)
    b = graphs.draw(traffic, 2 ** 31 + 3)
    assert not np.array_equal(a["train"], b["train"])
    sizes = {0: a["n_entities"], 1: a["n_relations"], 2: a["n_entities"]}
    for split in ("train", "valid", "test"):
        assert a[split].shape == b[split].shape
        for col, n in sizes.items():
            assert degrees(a[split][:, col], n) == \
                degrees(b[split][:, col], n)
    again = graphs.draw(traffic, 1)
    assert all(np.array_equal(a[k], again[k])
               for k in ("train", "valid", "test"))
