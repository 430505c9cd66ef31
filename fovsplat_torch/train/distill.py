"""SH-degree distillation: teacher -> student with pseudo ground truth
(counterpart of fovsplat/train/distill.py, LightGaussian/distill_train.py).

A high-SH-degree teacher renders pseudo ground truth; a reduced-degree
student (same geometry, truncated SH) is fine-tuned photometrically
against those renders. The student's extra coefficients are dropped,
shrinking the model by (K_teacher - K_student) * 3 floats a Gaussian.

The teacher renders through loops.render_state (kernels 4 and 5 on the
card) and the student takes loops' photometric step at its own degree
(kernels 4-7), on the device of the teacher's state. The view order is
the JAX package's random.Random(seed) stack.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from fovsplat_torch.models import state as S
from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
from fovsplat_torch.ops import sh as sh_mod
from fovsplat_torch.train import loops, optim


def truncate_sh(params: GaussianParams, student_degree: int
                ) -> GaussianParams:
    k = sh_mod.num_sh_coeffs(student_degree) - 1
    f = {name: getattr(params, name) for name in FIELDS}
    f["features_rest"] = f["features_rest"][:, :k]
    return GaussianParams(**f)


def distill(teacher: S.TrainerState, views: Sequence, student_degree: int,
            cfg: loops.LoopConfig, iters: int = 2000, seed: int = 0,
            log: Callable = print) -> S.TrainerState:
    """Returns a trained student state with SH degree `student_degree`.
    cfg.sh_degree is the teacher's degree."""
    dev = teacher.live.device
    student_params = truncate_sh(teacher.params, student_degree)
    student = S.TrainerState(params=student_params,
                             opt=optim.init_state(student_params),
                             live=teacher.live)
    step = loops.make_photometric_step(
        dataclasses.replace(cfg, sh_degree=student_degree), device=dev)

    stack = loops._ViewStack(views, seed)
    for it in range(1, iters + 1):
        v = stack.pop()
        with torch.no_grad():
            pseudo = loops.render_state(teacher, v.camera, cfg)["render"]
        student, aux = step(student, v.camera, pseudo, it)
        if it % 200 == 0:
            log(f"[distill] it={it} loss={float(aux['loss']):.5f}")
    return student
