"""Host-driven control loop against a plant.

Torch twin of pdmpc_tpu/hlc.py. ``experiment.run_experiment`` runs the
receding-horizon loop with the plant's apply inside the step; this module
is the reference-shaped loop that interleaves plant I/O with the step —
the HighLevelController.run template (hlc/controller/
HighLevelController.m:67-94,334-373):

  main_init -> synchronize_start_with_plant -> loop { measure -> control
  step -> apply } -> end_run / save results

Used with :class:`pdmpc_torch.plant.ExternalPlant` (the CpmLab-shaped
adapter, ``plant_bridge`` for a plant in another process) or with the
simulation plant for per-step host access (``visualization.
PlotterOnline``). The step is the one ``run_experiment`` runs, on a batch
of one scenario, so with the simulation plant both give the same records
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from pdmpc_torch import resolve_device
from pdmpc_torch.config import Config
from pdmpc_torch.controller import (
    StepInfo,
    StepState,
    make_centralized_step,
    make_prioritized_step,
)
from pdmpc_torch.experiment import ExperimentResult, create_scenario, git_hash
from pdmpc_torch.models.mpa import build_mpa
from pdmpc_torch.parallel.sharded import batched_initial_state
from pdmpc_torch.plant import Plant, get_plant
from pdmpc_torch.utils.filenames import results_directory
from pdmpc_torch.utils.timing import ControllerTiming


def run_with_plant(options: Config, plant: Plant | None = None,
                   on_step=None, device=None) -> ExperimentResult:
    """Run an experiment against a plant, one step per period, on
    ``device`` (default CUDA; raises if CUDA is absent). Default plant:
    ``plant.get_plant`` at the scenario's start poses.

    Each period: ``measure`` (the plant's poses, float64, and each
    vehicle's trim from its measured speed and steering, written into the
    state as float32 and int64), ``plan`` (one step; on CUDA the span ends
    in ``torch.cuda.synchronize``, so it holds the device work), then the
    step's records are copied to the host and ``apply`` hands them to the
    plant. ``on_step(k, info)`` is an optional observer (the live-plotting
    topic, visualization/PlotterOnline.m); a truthy return ends the run
    after step ``k``. On any exception the completed steps are saved as a
    partial result (never served by ``utils.filenames.load_latest``) and
    the exception is re-raised. Records come without the scenario dim, as
    ``run_experiment`` returns them; timings hold the ``measure``,
    ``plan`` and ``apply`` spans a step and the once-only
    ``hlc_init_all`` and ``control_loop``, as [2, n] (start; duration)
    lists.
    """
    device = resolve_device(device)
    options = options.validate()
    timing = ControllerTiming()

    timing.start("hlc_init_all")
    mpa = build_mpa(options)
    scenario = create_scenario(options, mpa)
    mpa_t = mpa.to_tensors_for(options, device)
    sc_t = scenario.to_tensors(device)
    if plant is None:
        plant = get_plant(options, start_poses=scenario.start_poses)
    builder = (make_prioritized_step if options.is_prioritized
               else make_centralized_step)
    step = builder(options, mpa_t, sc_t)
    state = batched_initial_state(sc_t, options.Hp, 1)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    timing.stop("hlc_init_all")

    plant.synchronize_start_with_plant()
    infos: list[StepInfo] = []

    def build_result() -> ExperimentResult:
        return ExperimentResult(
            options=options,
            infos=StepInfo(*(np.stack(f) for f in zip(*infos))),
            final_state=StepState(*(x[0].cpu() for x in state)),
            timings={k2: v.tolist() if isinstance(v, np.ndarray) else v
                     for k2, v in timing.get_all_timings().items()},
            git_hash=git_hash(),
        )

    k = 0
    timing.start("control_loop")
    try:
        while not plant.should_stop() and k < options.k_end:
            with timing.span("measure", k):
                m = plant.measure()
                trims = [mpa.trim_from_values(m.speed[v], m.steering[v])
                         for v in range(scenario.n_vehicles)]
                state = state._replace(
                    pose=torch.as_tensor(m.poses, dtype=torch.float32,
                                         device=device)[None],
                    trim=torch.as_tensor(trims, dtype=torch.int64,
                                         device=device)[None])

            with timing.span("plan", k):
                state, info = step(state, k)
                sync()

            info_np = StepInfo(*(x[0].cpu().numpy() for x in info))
            infos.append(info_np)

            with timing.span("apply", k):
                applied = info_np.trims[:, 0]
                plant.apply(info_np.poses, info_np.trims, k,
                            trim_speeds=mpa.trim_speed[applied],
                            trim_steerings=mpa.trim_steering[applied])

            # truthy return requests abort (visualization.PlotterOnline's
            # ESC hotkey, the reference Plotter.m abort path)
            if on_step is not None and on_step(k, info_np):
                k += 1
                break
            k += 1
    except BaseException:
        # save-on-error: persist whatever completed before the failure, the
        # reference's onCleanup path (HighLevelController.m:508-555)
        timing.stop("control_loop")
        if infos:
            try:
                base = build_result().save(results_directory(options),
                                           partial=True)
                print(f"run aborted at step {k}; partial result saved to "
                      f"{base}.npz")
            except Exception as save_err:  # noqa: BLE001 — don't mask
                print(f"run aborted at step {k}; partial save failed: "
                      f"{save_err!r}")
        plant.end_run()
        raise

    timing.stop("control_loop")
    plant.end_run()
    return build_result()
