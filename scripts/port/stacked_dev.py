"""The stacked models on the card, piece by piece: `chip_smoke.py`'s two
stacked phases, the dryrun (part 2 included) on 1, 2 and 4 ranks, the two
experiment drivers (results under `chiprun_out/results_torch/`), and a
`torch.profiler` trace of one stacked config-5 step (B = 4, T = 25 000,
float32) beside one series' step.

    python3 scripts/port/stacked_dev.py [stacked] [profile] [dryrun] [experiments]

(no argument: stacked, dryrun, experiments)."""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
import chip_smoke as cs  # noqa: E402
import physs_gp_tpu_torch.ops.matrix  # noqa: E402,F401  (TF32 off)
import torch  # noqa: E402


def profile(which, form, B, T):
    from physs_gp_tpu_torch.models.stacked import StackedCVIGP
    from torch.profiler import ProfilerActivity, profile as prof

    with cs._knob(form):
        models = cs._stacked_members(which, form, B, T, T, torch.float32, 7)
        one = models[0]
        st = StackedCVIGP(models)
        for tag, m in (("stacked", st), ("single", one)):
            m.step_with_elbo(0.5)
            torch.cuda.synchronize()
            with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                t0 = time.perf_counter()
                m.step_with_elbo(0.5)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ka = p.key_averages()  # the tables end with the host's and the device's totals
            print(f"[profile {which} {form} B={B} T={T} {tag}] wall {wall:.4f} s")
            print(ka.table(sort_by="self_cpu_time_total", row_limit=18, max_name_column_width=60))
            print(ka.table(sort_by="self_device_time_total", row_limit=12, max_name_column_width=60))


def main(what):
    cs._timed(cs.phase_device)
    cs._timed(cs.phase_build)
    if "stacked" in what:
        cs._timed(cs.phase_stacked_anchor)
        os.environ["PHYSS_KZZ_JITTER"] = "1e-4"
        cs._timed(cs.phase_stacked_full)
        del os.environ["PHYSS_KZZ_JITTER"]
    if "profile" in what:
        profile("config5", "cov", 4, 25_000)
    if "dryrun" in what:
        from physs_gp_tpu_torch.parallel.dryrun import dryrun_multichip
        for n in (1, 2, 4):
            t0 = time.perf_counter()
            dryrun_multichip(n, device="cuda", timeout=400)
            print(f"[dryrun n={n}] {time.perf_counter() - t0:.1f} s", flush=True)
    if "experiments" in what:
        for args in (["experiments_torch/pendulum.py", "--quick"], ["experiments_torch/monotonic.py"]):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, *args, "--out", "chiprun_out/results_torch"])
            print(f"[{args[0]}] rc {r.returncode} {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["stacked", "dryrun", "experiments"])
