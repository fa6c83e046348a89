"""The port's ``cli.eval_ycb --native_crops on`` (variable ladder-shape
crops through the shape-bucketed dispatch) against the JAX CLI on the same
JAX-written checkpoint and synthetic YCB root, held as
``test_torch_eval_ycb.py`` holds the other two routes. A file of its own:
the JAX CLI compiles a pipeline for every crop shape."""

from tests.test_torch_eval_ycb import check_route, data, runs  # noqa: F401


def test_native_route_matches_jax(data, runs):  # noqa: F811
    check_route(data, runs, "native")
