"""Small CPU sizes of the benchmark's configurations, for the tests."""

SMALL = {"ref_dense_n8192": {"n": 384, "maxiter": 384},
         "tpucg_fem_p1_300k": {"n_points": 1500}}


def small_config(config: dict) -> dict:
    """The configuration at a size a CPU test holds (its name changed, so
    that nothing it caches is taken for the real one's)."""
    return dict(config, **SMALL[config["name"]], name=config["name"] + "_small")
