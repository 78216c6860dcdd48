"""Trigger fixture for the port's config-gate-docs rule: a stand-in for
core/rounds.py whose loop picker grew a gate on a SimConfig field
(hb_grace) that neither BASELINE.md's config-gate matrix nor the README's
port block documents.  Mounted (shadowing core/rounds.py) by
tests/test_torch_analysis.py only -- never imported."""


def _lean_ok(config, matrix_events, scenario=None, nloc=None):
    if matrix_events or config.hb_dtype != "int8":
        return False
    # an undocumented capability gate
    return config.hb_grace <= 1


def route(config, matrix_events=False, scenario=None, nloc=None):
    if _lean_ok(config, matrix_events, scenario, nloc):
        return "lean", "aligned_group"
    return "separate", "fused_merge_update"
