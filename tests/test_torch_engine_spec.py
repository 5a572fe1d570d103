"""The port's EngineSpec / resolve_engine / DotEngine.spec() against the
reference's (`repro.core.numerics`): the same specs resolve to engines
with the same fields, the `_UNSET` sentinel inherits where an explicit
None clears a pin, the error cases raise the same errors, and a
ServeEngine built from a spec equals one built from the legacy keywords.
The mesh-sharded fields are refused (the sharded GEMMs are not ported).
Cases follow tests/test_distributed_matmul.py::TestEngineSpec and
tests/test_dot_engine.py::TestServingWiring.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import numerics as jnum
from repro_torch.core import numerics as tnum
from repro_torch.core.numerics import DotEngine, EngineSpec, resolve_engine
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServeEngine

# The fields both packages' DotEngine carry (the reference adds its TPU
# deployment knobs and the mesh fields).
FIELDS = ("mode", "k_tile", "block_m", "block_n", "tiling", "layer_modes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(eng):
    return {f: getattr(eng, f) for f in FIELDS}


ENGINES = [dict(), dict(mode="olm16"), dict(mode="olm32t16", tiling="auto"),
           dict(mode="olm24", k_tile=8, block_m=16, block_n=8),
           dict(mode="olm16", layer_modes={"head": "olm32"})]


@pytest.mark.parametrize("kw", ENGINES, ids=lambda kw: kw.get("mode", "-"))
def test_round_trip(kw):
    eng = DotEngine(**kw)
    assert resolve_engine(eng.spec()) == eng
    assert _fields(eng) == _fields(jnum.resolve_engine(
        jnum.DotEngine(**kw).spec()))


@pytest.mark.parametrize("spec", [dict(n_bits=16), dict(n_bits=32, trunc=16),
                                  dict(mode="olm8"), dict()])
def test_structural_and_named_modes_resolve_as_the_reference(spec):
    assert _fields(resolve_engine(EngineSpec(**spec))) == \
        _fields(jnum.resolve_engine(jnum.EngineSpec(**spec)))


@pytest.mark.parametrize("spec,err,match", [
    (dict(n_bits=32, trunc=7), ValueError, "unregistered mode"),
    (dict(mode="olm16", n_bits=16), ValueError, "not both"),
    (dict(trunc=16), ValueError, "trunc"),
])
def test_errors_as_the_reference(spec, err, match):
    for mod in (tnum, jnum):
        with pytest.raises(err, match=match):
            mod.resolve_engine(mod.EngineSpec(**spec))


def test_unset_inherits_and_none_clears():
    for mod in (tnum, jnum):
        base = mod.DotEngine(mode="olm16", k_tile=8, tiling="auto")
        eng = mod.resolve_engine(mod.EngineSpec(mode="olm24"), base=base)
        assert (eng.mode, eng.k_tile, eng.tiling) == ("olm24", 8, "auto")
        eng = mod.resolve_engine(mod.EngineSpec(k_tile=None), base=base)
        assert eng.k_tile is None and eng.tiling == "auto"
        assert mod.EngineSpec().k_tile is mod._UNSET
        assert repr(mod._UNSET) == "<unset>"
        assert mod._Unset() is mod._UNSET
    with pytest.raises(TypeError, match="base must be a DotEngine"):
        resolve_engine(EngineSpec(), base="olm16")


def test_dict_fields_normalize_and_hash_as_the_reference():
    kw = dict(mode="olm16", layer_modes={"mlp": "olm32t16"},
              quality_tiers={"gold": "olm32", "bronze": "olm8"},
              degrade_ladder=["olm16", "olm8"])
    s, j = EngineSpec(**kw), jnum.EngineSpec(**kw)
    assert hash(s) == hash(EngineSpec(**kw))
    for f in ("layer_modes", "quality_tiers", "degrade_ladder"):
        assert getattr(s, f) == getattr(j, f)


@pytest.mark.parametrize("field", ["mesh", "shard", "shard_axis"])
def test_sharding_fields_are_refused(field):
    with pytest.raises(NotImplementedError, match="item 8"):
        EngineSpec(**{field: "m"})
    with pytest.raises(NotImplementedError, match="item 8"):
        resolve_engine(EngineSpec(mode="olm16"), mesh=object())


def _model(mode="native"):
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=16,
                      n_heads=2, n_kv_heads=2, d_ff=32, vocab_size=512,
                      param_dtype="float32", compute_dtype="float32")
    model = Model(cfg, DotEngine(mode=mode), device="cpu")
    return model, model.init(seed=0)


def _run(model, params, **kw):
    eng = ServeEngine(model, params, slots=2, max_len=16, device="cpu", **kw)
    rng = np.random.default_rng(0)
    for rid in range(3):
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(1, 512, 5).astype(np.int32),
                           max_new_tokens=4))
    done = sorted(eng.run(), key=lambda r: r.rid)
    return eng, [list(r.output) for r in done]


def test_engine_spec_equals_legacy_keywords():
    model, params = _model()
    e_new, out_new = _run(model, params,
                          engine=EngineSpec(mode="olm16", tiling="auto"))
    e_old, out_old = _run(model, params, dot_mode="olm16", dot_tiling="auto")
    assert out_new == out_old
    assert e_new.model.eng == e_old.model.eng
    assert e_new.model.eng.mode == "olm16"


def test_engine_and_legacy_keywords_are_exclusive():
    model, params = _model()
    with pytest.raises(ValueError, match="not both"):
        ServeEngine(model, params, engine=EngineSpec(mode="olm16"),
                    dot_mode="olm16", device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        ServeEngine(model, params, mesh=object(), device="cpu")


def test_spec_carries_serving_fields():
    model, params = _model("olm16")
    spec = EngineSpec(mode="olm16",
                      quality_tiers={"gold": "olm32", "bronze": "olm8"},
                      degrade_ladder=("olm16", "olm8"))
    eng, _ = _run(model, params, engine=spec)
    # the ladder's rungs below the base join the tiers under their own name
    assert eng.quality_tiers == {"gold": "olm32", "bronze": "olm8",
                                 "olm8": "olm8"}
    assert eng.degrade is not None and eng.degrade.ladder == ("olm16", "olm8")


def test_mode_override_keeps_the_deployment_knobs():
    # TestServingWiring: a dot_mode override keeps the other engine
    # fields and the config; no override keeps the model itself
    model, params = _model()
    model = Model(model.cfg, dataclasses.replace(model.eng, k_tile=8,
                                                 block_n=32), device="cpu")
    eng = ServeEngine(model, params, slots=1, max_len=8, dot_mode="olm16",
                      device="cpu")
    assert eng.model.eng.mode == "olm16"
    assert (eng.model.eng.k_tile, eng.model.eng.block_n) == (8, 32)
    assert eng.model.cfg is model.cfg
    assert ServeEngine(model, params, slots=1, max_len=8,
                       device="cpu").model is model
