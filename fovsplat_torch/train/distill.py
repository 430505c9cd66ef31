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

On the card the teacher's render is one CUDA graph per camera shape
(utils/graphs.graphed_camera; JAX jits it at distill.py:37), made once a
distill call. The teacher does not change in the loop, so its tensors
are read by the graph where they lie, as jax.jit bakes the closed-over
teacher in: copying its 1.16M rows into static inputs each iteration
would cost a copy of the model per view and a second copy's memory for
nothing. The student's step is loops' graphed photometric step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from fovsplat_torch.models import state as S
from fovsplat_torch.models.gaussians import FIELDS, GaussianParams
from fovsplat_torch.ops import sh as sh_mod
from fovsplat_torch.train import loops, optim
from fovsplat_torch.utils import graphs


def truncate_sh(params: GaussianParams, student_degree: int
                ) -> GaussianParams:
    k = sh_mod.num_sh_coeffs(student_degree) - 1
    f = {name: getattr(params, name) for name in FIELDS}
    f["features_rest"] = f["features_rest"][:, :k]
    return GaussianParams(**f)


def teacher_render(teacher: S.TrainerState, cfg: loops.LoopConfig):
    """render(camera) -> the teacher's (H, W, 3) render without a
    gradient: eager for a state on the CPU, else a CUDA graph per camera
    shape that reads the teacher's tensors in place (graphed_camera)."""
    def render(camera):
        with torch.no_grad():
            return loops.render_state(teacher, camera, cfg)["render"]

    if teacher.live.device.type == "cpu":
        return render
    return graphs.graphed_camera(render)


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

    render = teacher_render(teacher, cfg)
    stack = loops._ViewStack(views, seed)
    for it in range(1, iters + 1):
        v = stack.pop()
        pseudo = render(v.camera)
        student, aux = step(student, v.camera, pseudo, it)
        if it % 200 == 0:
            log(f"[distill] it={it} loss={float(aux['loss']):.5f}")
    return student
