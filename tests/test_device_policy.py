"""Device policy on the host side: where compilations are cached, which
engine a run picks and what it logs, how degradations are counted, and
that pool workers never open an accelerator."""

import logging

import pytest


@pytest.fixture()
def cache_config():
    import jax

    before = jax.config.jax_compilation_cache_dir
    yield jax
    jax.config.update("jax_compilation_cache_dir", before)


class TestCompileCache:
    def test_default_dir_is_fixed_in_checkout(self, cache_config, monkeypatch):
        import calitas_tpu

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        calitas_tpu._enable_jax_compilation_cache()
        want = calitas_tpu.DEFAULT_JAX_CACHE_DIR
        assert cache_config.config.jax_compilation_cache_dir == want
        assert want.endswith(".jax_cache")
        # inside the checkout, beside the package
        assert calitas_tpu.__file__.startswith(want[: -len(".jax_cache")])

    def test_env_dir_left_alone(self, cache_config, monkeypatch, tmp_path):
        import calitas_tpu

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        cache_config.config.update("jax_compilation_cache_dir", str(tmp_path))
        calitas_tpu._enable_jax_compilation_cache()
        assert cache_config.config.jax_compilation_cache_dir == str(tmp_path)


class TestEngine:
    @pytest.mark.parametrize("name", ["device", "tpu"])
    def test_device_and_alias_parse(self, name):
        from calitas_tpu.cli import build_parser

        for cmd in (
            ["SearchReference", "-i", "ACGTnrg", "-I", "g", "-r", "x.fa"],
            ["AlignToReference", "-i", "q.txt", "-r", "x.fa"],
            ["PairwiseAlignSequences", "-i", "p.txt"],
        ):
            args = build_parser().parse_args(cmd + ["--engine", name])
            assert args.engine == name

    def test_unknown_engine_rejected(self):
        from calitas_tpu.tools.search_reference import _resolve_engine

        with pytest.raises(ValueError):
            _resolve_engine("gpu0")

    @pytest.mark.parametrize("name", ["device", "tpu"])
    def test_device_engine_logs_the_device(self, name, caplog):
        import jax

        from calitas_tpu.tools.search_reference import _resolve_engine

        with caplog.at_level(logging.INFO, "calitas_tpu.engine"):
            assert _resolve_engine(name)
        dev = jax.devices()[0]
        [msg] = [r.getMessage() for r in caplog.records
                 if r.name == "calitas_tpu.engine"]
        assert dev.platform in msg and dev.device_kind in msg

    def test_host_and_auto_on_cpu(self, caplog):
        from calitas_tpu.tools.search_reference import _resolve_engine

        with caplog.at_level(logging.INFO, "calitas_tpu.engine"):
            assert not _resolve_engine("host")
            assert not _resolve_engine("auto")  # CPU backend: host engine
        assert not [r for r in caplog.records if r.name == "calitas_tpu.engine"]


class TestDegradationCounter:
    def test_counts_by_site_and_logs(self, caplog):
        from calitas_tpu.utils import (
            degradations,
            note_degraded,
            reset_degradations,
        )

        reset_degradations()
        with caplog.at_level(logging.WARNING, "calitas_tpu.degraded"):
            note_degraded("staging", "chr1")
            note_degraded("staging", "chr2")
            note_degraded("variant screen")
        assert degradations() == {"staging": 2, "variant screen": 1}
        msgs = [r.getMessage() for r in caplog.records]
        assert any("staging (chr1)" in m for m in msgs)
        reset_degradations()
        assert degradations() == {}


def test_pool_workers_pin_jax_to_cpu(monkeypatch):
    import os

    from calitas_tpu.parallel.host_pool import _pin_worker_to_cpu

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    _pin_worker_to_cpu()
    assert os.environ["JAX_PLATFORMS"] == "cpu"
