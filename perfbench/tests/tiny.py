"""Small copies of the cells' configuration and traffic, which the CPU
tests run through the whole harness in a second or two."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def config(name="densefusion-ycb"):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(num_obj=4, num_points=48, num_mesh_points=24, crop_size=48,
               symmetric=[1, 3])
    return cfg


def traffic(name):
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    t.update(batch=4, pool=2)
    for k in ("warmup", "traced_requests", "traced_steps"):
        if k in t:
            t[k] = 1
    return t


LIMITS = {"q_gap": 1e-4, "t_gap": 1e-4, "conf_gap": 1e-5, "q0_gap": 1e-4,
          "t0_gap": 1e-4, "dis_gap": 1e-4, "loss_gap": 1e-2,
          "grad_gap": 1e-3, "change_gap": 1e-2}


def limits():
    return copy.deepcopy(LIMITS)
