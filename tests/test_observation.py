"""Tree StarModel + ObservationTree tests.

Mirrors the reference's test strategy:
* tests/test_likelihood.py:14-57 — StarModel (tree) vs BasicStarModel (fused)
  lnlike consistency: the internal cross-implementation oracle;
* tests/test_ini.py:42-126 — star.ini fixtures through from_ini with asserted
  systems/Nstars/n_params and finite lnpost at valid points.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from isochrones_tpu import get_ichrone
from isochrones_tpu.observation import (
    Observation,
    ObservationTree,
    Source,
)
from isochrones_tpu.starmodel import BasicStarModel, SingleStarModel
from isochrones_tpu.treemodel import StarModel, StarModelGroup

FIXTURES = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def iso():
    return get_ichrone("synthetic", n_feh=7, n_mass=30, n_eep=100, n_age=30)


def _true_star(iso, eep=60.0, age=9.0, feh=0.0, distance=200.0, AV=0.1, bands=("J", "H", "K")):
    Teff, logg, feh_m, mags = iso.interp_mag([eep, age, feh, distance, AV], list(bands))
    return Teff, logg, dict(zip(bands, np.asarray(mags)))


# ------------------------------------------------------- tree vs fused oracle
@pytest.mark.parametrize("props", ["spec_only", "phot_only", "both"])
def test_single_consistency(iso, props):
    """StarModel (tree) and BasicStarModel (fused kernel) agree on lnlike for
    unresolved single stars (reference test_likelihood.py:14-57)."""
    Teff, logg, mags = _true_star(iso)
    kw = {}
    if props in ("spec_only", "both"):
        kw.update(Teff=(Teff, 100.0), logg=(logg, 0.1))
    if props in ("phot_only", "both"):
        kw.update(J=(mags["J"], 0.02), H=(mags["H"], 0.02))
    kw["parallax"] = (5.0, 0.05)

    tree_mod = StarModel(iso, **kw)
    flat_mod = SingleStarModel(iso, **kw)
    # sync priors, as the reference oracle does (test_likelihood.py:19-21)
    for k in ["mass", "feh", "age", "distance", "AV", "eep"]:
        flat_mod.set_prior(**{k: tree_mod._priors[k]})
    p = [60.0, 9.0, 0.0, 200.0, 0.1]
    assert np.isclose(tree_mod.lnlike(p), flat_mod.lnlike(p), atol=1e-8)
    assert np.isclose(tree_mod.lnprior(p), flat_mod.lnprior(p), atol=1e-8)
    assert np.isclose(tree_mod.lnpost(p), flat_mod.lnpost(p), atol=1e-8)


def test_binary_consistency(iso):
    """Unresolved binary: tree model with N=2 == BasicStarModel(N=2)."""
    Teff, logg, mags = _true_star(iso)
    kw = dict(J=(mags["J"], 0.02), H=(mags["H"], 0.02), parallax=(5.0, 0.05))
    tree_mod = StarModel(iso, N=2, **kw)
    flat_mod = BasicStarModel(iso, N=2, **kw)
    for k in ["mass", "feh", "age", "distance", "AV", "eep"]:
        flat_mod.set_prior(**{k: tree_mod._priors[k]})
    p = [60.0, 50.0, 9.0, 0.0, 200.0, 0.1]
    assert np.isclose(tree_mod.lnlike(p), flat_mod.lnlike(p), atol=1e-8)
    assert np.isclose(tree_mod.lnpost(p), flat_mod.lnpost(p), atol=1e-8)


def test_tree_batch_matches_host(iso):
    """Batched XLA tree lnlike == host-side per-node walk."""
    Teff, logg, mags = _true_star(iso)
    m = StarModel(iso, Teff=(Teff, 100.0), J=(mags["J"], 0.02), parallax=(5.0, 0.05))
    rng = np.random.default_rng(0)
    for _ in range(5):
        p = [60.0 + rng.normal(0, 5), 9.0 + rng.normal(0, 0.05), rng.normal(0, 0.1),
             200.0 + rng.normal(0, 10), abs(rng.normal(0.1, 0.05))]
        pardict = m.obs.p2pardict(p)
        model_values = {}
        for star, pars in pardict.items():
            T, g, f, mg = iso.interp_mag(pars, m.bands)
            vals = {"Teff": T, "logg": g, "feh": f}
            vals.update({b: float(v) for b, v in zip(m.bands, mg)})
            model_values[star] = vals
        host = m.obs.lnlike(pardict, model_values)
        assert np.isclose(host, m.lnlike(p), atol=1e-8), (host, m.lnlike(p))


# ------------------------------------------------------------- tree building
def test_tree_structure_resolution_order():
    t = ObservationTree()
    o_coarse = Observation("coarse", "J", 10.0)
    o_coarse.add_source(Source(9.0, 0.02))
    o_fine = Observation("fine", "K", 0.1)
    o_fine.add_source(Source(9.1, 0.02))
    t.add_observation(o_fine)
    t.add_observation(o_coarse)
    # coarse observation should sit above fine in the hierarchy
    assert [o.name for o in t.observations] == ["coarse", "fine"]
    obs_nodes = t.get_obs_nodes()
    coarse_node = [n for n in obs_nodes if n.instrument == "coarse"][0]
    fine_node = [n for n in obs_nodes if n.instrument == "fine"][0]
    assert fine_node.parent is coarse_node


def test_resolved_sources_attach_separately(iso):
    """Two well-separated sources stay separate systems when index differs."""
    t = ObservationTree()
    o = Observation("cam", "J", 1.0)
    o.add_source(Source(9.0, 0.02, separation=0.0, pa=0.0))
    o.add_source(Source(10.0, 0.02, separation=20.0, pa=90.0))
    t.add_observation(o)
    t.define_models(iso, N=1, index=[0, 1])
    assert t.Nstars == {0: 1, 1: 1}
    assert sorted(t.systems) == [0, 1]
    assert t.param_description == [
        "eep_0_0", "age_0", "feh_0", "distance_0", "AV_0",
        "eep_1_0", "age_1", "feh_1", "distance_1", "AV_1",
    ]


def test_p2pardict_roundtrip(iso):
    t = ObservationTree()
    o = Observation("cam", "J", 1.0)
    o.add_source(Source(9.0, 0.02))
    t.add_observation(o)
    t.define_models(iso, N=2, index=0)
    p = [60.0, 50.0, 9.0, 0.0, 200.0, 0.1]
    d = t.p2pardict(p)
    assert d["0_0"] == [60.0, 9.0, 0.0, 200.0, 0.1]
    assert d["0_1"] == [50.0, 9.0, 0.0, 200.0, 0.1]
    assert t.pardict2p(d) == p


# ------------------------------------------------------------------ from_ini
def test_ini_single(iso):
    m = StarModel.from_ini(iso, folder=os.path.join(FIXTURES, "star1"))
    assert m.obs.Nstars == {0: 1}
    assert m.n_params == 5
    assert set(m.bands) == {"J", "H", "K", "W1", "W2"}
    p = [60.0, 9.0, 0.0, 200.0, 0.1]
    assert np.isfinite(m.lnlike(p))
    assert np.isfinite(m.lnpost(p))
    # spectroscopy attached to primary
    assert "Teff" in m.obs.spectroscopy["0_0"]


def test_ini_two_sources(iso):
    m = StarModel.from_ini(iso, folder=os.path.join(FIXTURES, "star2"))
    # two resolved sources -> two leaves in finest observation
    assert sum(m.obs.Nstars.values()) == 2
    p = []
    for s in m.obs.systems:
        p += [60.0] * m.obs.Nstars[s] + [9.0, 0.0, 200.0, 0.1]
    assert np.isfinite(m.lnlike(p))


@pytest.mark.slow
def test_ini_relative_companions(iso):
    m = StarModel.from_ini(iso, folder=os.path.join(FIXTURES, "star3"))
    # AO companions: 3 stars total (primary + 2 companions)
    assert sum(m.obs.Nstars.values()) == 3
    assert m.n_params == sum(4 + n for n in m.obs.Nstars.values())
    # relative obs nodes present
    rel_nodes = [n for n in m.obs.get_obs_nodes() if n.relative]
    assert len(rel_nodes) > 0
    p = []
    for s in m.obs.systems:
        n = m.obs.Nstars[s]
        p += sorted([60.0 - 5 * j for j in range(n)], reverse=True) + [9.0, 0.0, 200.0, 0.1]
    assert np.isfinite(m.lnlike(p))
    assert np.isfinite(m.lnpost(p))


def _host_tree_lnlike(m, p):
    """Host-side per-node tree walk at parameter vector ``p`` (the
    test_tree_batch_matches_host pattern)."""
    pardict = m.obs.p2pardict(p)
    model_values = {}
    for star, pars in pardict.items():
        T, g, f, mg = m.ic.interp_mag(pars, m.bands)
        vals = {"Teff": T, "logg": g, "feh": f}
        vals.update({b: float(v) for b, v in zip(m.bands, mg)})
        model_values[star] = vals
    return m.obs.lnlike(pardict, model_values)


def test_ini_band_asymmetric_companions(iso):
    """star4: companion 1 in H+K, companion 2 in H ONLY (band-asymmetric
    relative photometry, reference tests/star4 + observation.py:464-491).
    Covers the relative-referencing branch where companions differ in band
    coverage — host per-node walk must equal the compiled batched plan."""
    m = StarModel.from_ini(iso, folder=os.path.join(FIXTURES, "star4"))
    # primary + 2 companions, one system
    assert m.obs.systems == [0]
    assert m.obs.Nstars == {0: 3}
    assert m.n_params == 7
    # companion 2's H row is relative; it has NO K counterpart
    rel_nodes = [n for n in m.obs.get_obs_nodes() if n.relative]
    rel_by_band = {}
    for n in rel_nodes:
        rel_by_band.setdefault(n.band, []).append(n)
    assert len(rel_by_band.get("H", [])) > len(rel_by_band.get("K", [])), (
        "fixture must be band-asymmetric: more relative H rows than K"
    )
    # mass pars -> EEP conversion, finite lnlike (reference TripleCheck)
    pars = [1.2, 1.0, 0.8, 9.0, 0.0, 100.0, 0.1]
    eep_pars = m.convert_pars_to_eep(pars)
    assert len(eep_pars) == m.n_params
    assert np.isfinite(m.lnlike(eep_pars))
    # host-vs-batched equality on the asymmetric-coverage branch
    rng = np.random.default_rng(4)
    for _ in range(5):
        p = [
            65.0 + rng.normal(0, 3), 50.0 + rng.normal(0, 3), 40.0 + rng.normal(0, 3),
            9.0 + rng.normal(0, 0.05), rng.normal(0, 0.1),
            100.0 + rng.normal(0, 5), abs(rng.normal(0.1, 0.05)),
        ]
        host = _host_tree_lnlike(m, p)
        batched = m.lnlike(p)
        assert np.isclose(host, batched, atol=1e-8), (host, batched)


def test_ini_band_asymmetric_unassoc_variants(iso):
    """star4 with unassociated-companion index splits (reference
    TripleCheck_Unassoc1/2): systems/Nstars/n_params bookkeeping and finite
    host==batched lnlike for each association pattern."""
    for index, systems, Nstars, p in [
        ([0, 0, 1], [0, 1], {0: 2, 1: 1},
         [65.0, 50.0, 9.0, 0.0, 100.0, 0.1, 60.0, 9.2, 0.0, 300.0, 0.2]),
        ([0, 1, 1], [0, 1], {0: 1, 1: 2},
         [65.0, 9.0, 0.0, 100.0, 0.1, 60.0, 45.0, 9.2, 0.0, 300.0, 0.2]),
    ]:
        m = StarModel.from_ini(iso, folder=os.path.join(FIXTURES, "star4"), index=index)
        assert m.obs.systems == systems
        assert m.obs.Nstars == Nstars
        assert m.n_params == 11
        host = _host_tree_lnlike(m, p)
        batched = m.lnlike(p)
        assert np.isfinite(batched)
        assert np.isclose(host, batched, atol=1e-8), (index, host, batched)


@pytest.mark.slow
def test_ini_prior_samples_finite(iso):
    m = StarModel.from_ini(iso, folder=os.path.join(FIXTURES, "star1"))
    p0 = m.emcee_p0(20)
    lnp = np.asarray(m.lnpost_batch(jnp.asarray(p0)))
    assert np.isfinite(lnp).all()


def test_get_bands(iso):
    bands = StarModel.get_bands(os.path.join(FIXTURES, "star1", "star.ini"))
    assert set(bands) == {"J", "H", "K", "W1", "W2"}


# ----------------------------------------------------------------- utilities
def test_obs_tree_df_roundtrip(iso):
    m = StarModel.from_ini(iso, folder=os.path.join(FIXTURES, "star2"))
    df = m.obs.to_df()
    t2 = ObservationTree.from_df(df)
    assert len(t2.get_obs_nodes()) == len(m.obs.get_obs_nodes())


def test_obs_tree_hdf_roundtrip(tmp_path, iso):
    m = StarModel.from_ini(iso, folder=os.path.join(FIXTURES, "star1"))
    fn = str(tmp_path / "obs.h5")
    m.obs.save_hdf(fn)
    t2 = ObservationTree.load_hdf(fn, ic=iso)
    assert t2.Nstars == m.obs.Nstars
    assert t2.parallax == m.obs.parallax
    assert t2.spectroscopy == m.obs.spectroscopy


@pytest.mark.slow
def test_tree_model_fit_smoke(iso):
    Teff, logg, mags = _true_star(iso)
    m = StarModel(iso, Teff=(Teff, 100.0), J=(mags["J"], 0.02), parallax=(5.0, 0.05))
    df = m.fit_mcmc(nwalkers=32, nburn=100, niter=20, seed=0)
    assert np.isfinite(df["lnprob"]).all()
    ds = m.derived_samples
    assert "J_mag" in ds.columns
    assert "mass_0_0" in ds.columns


@pytest.mark.slow
def test_tree_model_nested_fit_dynamic_default_recovers(iso, monkeypatch):
    """Tree StarModel.fit_multinest defaults to DYNAMIC nested sampling
    (tree likelihoods are expensive per call) and recovers
    the generating star within the posterior's central 95%."""
    import isochrones_tpu.samplers.nested as nested

    captured = {}
    orig = nested.run_nested
    monkeypatch.setattr(
        nested, "run_nested",
        lambda *a, **kw: (captured.update(kw), orig(*a, **kw))[1],
    )
    Teff, logg, mags = _true_star(iso)
    m = StarModel(iso, Teff=(Teff, 100.0), J=(mags["J"], 0.02),
                  K=(mags["K"], 0.02), parallax=(5.0, 0.05))
    res = m.fit_multinest(n_live_points=150, seed=4, min_ess=400)
    assert captured.get("dynamic") is True  # the dynamic default took effect
    assert np.isfinite(res.logz)
    assert res.ess >= 400
    df = m.samples
    lo, hi = np.percentile(df["distance_0"].values, [2, 98])
    assert lo <= 200.0 <= hi  # parallax 5 mas -> 200 pc truth


def test_star_model_group(iso):
    Teff, logg, mags = _true_star(iso)
    m = StarModel(iso, J=(mags["J"], 0.02), H=(mags["H"], 0.02))
    group = StarModelGroup(m, max_multiples=1, max_stars=2)
    assert len(group.models) >= 1
    for mod in group.models:
        assert mod.n_params == sum(4 + n for n in mod.obs.Nstars.values())


def test_add_limit(iso):
    Teff, logg, mags = _true_star(iso)
    m = StarModel(iso, Teff=(Teff, 100.0), J=(mags["J"], 0.02))
    m.obs.add_limit(logg=(logg + 1.0, None))  # model logg below limit -> -inf
    m._jit_cache.clear()
    assert m.lnlike([60.0, 9.0, 0.0, 200.0, 0.1]) == -np.inf
    m2 = StarModel(iso, Teff=(Teff, 100.0), J=(mags["J"], 0.02))
    m2.obs.add_limit(logg=(logg - 1.0, logg + 1.0))
    assert np.isfinite(m2.lnlike([60.0, 9.0, 0.0, 200.0, 0.1]))


def test_limits_hdf_roundtrip_preserves_infinities(tmp_path, iso):
    """Open-ended limits serialize as None; load must restore POSITIONALLY
    (-inf lower, +inf upper). Regression: both endpoints were restored as
    -inf, making every model fail the upper check after a round trip."""
    Teff, logg, mags = _true_star(iso)
    m = StarModel(iso, Teff=(Teff, 100.0), J=(mags["J"], 0.02))
    m.obs.add_limit(logg=(logg - 1.0, None))  # satisfied: lower bound below model
    p = [60.0, 9.0, 0.0, 200.0, 0.1]
    assert np.isfinite(m.lnlike(p))
    fn = str(tmp_path / "obs_limits.h5")
    m.obs.save_hdf(fn)
    t2 = ObservationTree.load_hdf(fn, ic=iso)
    (lo, hi), = [v for d in t2.limits.values() for v in d.values()]
    assert lo == pytest.approx(logg - 1.0)
    assert hi == np.inf


# -------------------------------------------------------------- ascii render
def test_print_ascii_annotated(iso):
    """print_ascii with pars annotates model mags/lnlikes per node
    (reference observation.py:40-113, 1175-1179)."""
    import io

    from isochrones_tpu.observation import MyLeftAligned, NodeTraversal

    Teff, logg, mags = _true_star(iso)
    m = StarModel(
        iso,
        Teff=(Teff, 100.0),
        J=(mags["J"], 0.02),
        parallax=(5.0, 0.05),
    )
    m.obs.add_limit(logg=(3.0, 5.5))

    # plain render: structure + constraint labels, no model values
    buf = io.StringIO()
    m.obs.print_ascii(fout=buf)
    plain = buf.getvalue()
    assert "J=" in plain and "0_0" in plain
    assert "Teff=" in plain and "logg limits=" in plain and "parallax=" in plain
    assert "model=" not in plain

    # annotated render: model mags, per-constraint lnlikes, par vector
    p = [60.0, 9.0, 0.0, 200.0, 0.1]
    buf = io.StringIO()
    m.obs.print_ascii(fout=buf, p=p)
    ann = buf.getvalue()
    assert ann.count("model=") >= 2  # photometry node + Teff spectroscopy
    assert "parallax=(5.0, 0.05); model=5.0" in ann
    assert ": [" in ann  # par vector echoed on the model node
    # the J-band annotation shows the actual interpolated model mag
    mag_model = float(np.squeeze(iso.interp_mag(p, ["J"])[3]))
    assert f"model={mag_model:.2f}" in ann

    # compat classes render standalone (asciitree-free)
    pardict = m.obs.p2pardict([float(x) for x in p])
    text = MyLeftAligned(pardict)(m.obs)
    assert text == ann
    trav = NodeTraversal()
    assert trav.get_children(m.obs) == m.obs.children
    assert trav.get_root(m.obs.children[0]) is m.obs
