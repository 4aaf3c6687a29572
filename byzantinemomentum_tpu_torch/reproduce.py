"""The paper's experiment grid on the port's driver:
`python -m byzantinemomentum_tpu_torch.reproduce`.

The port's scheduler of the root `reproduce.py` and
`reproduce-appendix.py` grids: every (dataset, GAR, attack, f, lr,
momentum-at, nesterov, seed) run, each command `[sys.executable, "-m",
"byzantinemomentum_tpu_torch", ...]` with the root scripts' flags, names
and order (its own copies of their `GARS`, `ATTACKS`, `submit_mnist`,
`submit_cifar`, `submit_faults`, `submit_smoke` and the appendix's
`submit`), through the port's `Jobs` (`utils/jobs.py`: skip-if-done,
retries with `--auto-resume`, adoption of stale runs, the heartbeat
watchdog).

Usage:
  python -m byzantinemomentum_tpu_torch.reproduce
      [--data-directory results-data] [--devices cuda[,cuda:1...]]
      [--supercharge N] [--subset smoke|faults|mnist|cifar|appendix|all]

`--devices` names one job slot per entry, `cuda` (the default) or
`cuda:<i>`; `cpu` runs only where it is named. `--subset appendix` runs
the WRN-28-10 grid of `reproduce-appendix.py` (its seeds 1-5), which
`all` leaves out as the root script does. SIGINT and SIGTERM set a latch
that stops the waiting (the root scripts' latch).

It schedules and does not plot: the root `study.py`, unchanged, reads the
result directories of either package, and the root `reproduce.py`'s
analysis runs over them (`reproduce.py::analyze(data_dir, plot_dir)`).
"""

import argparse
import pathlib
import signal
import sys

from byzantinemomentum_tpu_torch import utils
from byzantinemomentum_tpu_torch.utils.jobs import (DEFAULT_SEEDS, Jobs,
                                                    dict_to_cmdlist)

__all__ = ["GARS", "ATTACKS", "APPENDIX_GARS", "FAULT_RATES", "make_command",
           "submit_mnist", "submit_cifar", "submit_faults", "submit_smoke",
           "submit_appendix", "main"]

# The paper's GAR list and attacks (the root `reproduce.py`'s)
GARS = ("krum", "median", "trmean", "phocas", "meamed", "bulyan")
ATTACKS = (("little", ("factor:1.5", "negative:True")),
           ("empire", "factor:1.1"))
# The appendix's GARs (the root `reproduce-appendix.py`'s)
APPENDIX_GARS = ("krum", "median", "bulyan")
# The fault grid's per-worker-per-step rates (the root `reproduce.py`'s)
FAULT_RATES = (0.0, 0.005, 0.01, 0.02)

LAUNCHER = (sys.executable, "-m", "byzantinemomentum_tpu_torch")


def make_command(params):
    return list(LAUNCHER) + dict_to_cmdlist(params)


def submit_mnist(jobs):
    """(Fashion-)MNIST grid (the root `reproduce.py::submit_mnist`)."""
    base = {
        "batch-size": 83, "model": "simples-full", "loss": "nll",
        "learning-rate-decay-delta": 300, "momentum": 0.9,
        "l2-regularize": 1e-4, "evaluation-delta": 5, "gradient-clip": 2,
        "nb-steps": 300, "nb-for-study": 1, "nb-for-study-past": 150,
        "nb-workers": 51,
    }
    for ds in ("mnist", "fashionmnist"):
        for f, fm in ((24, 1), (12, 0)):
            for lr in (0.5, 0.02):
                for nesterov in (False, True):
                    suffix = "-nesterov" if nesterov else ""
                    params = dict(base, dataset=ds)
                    params["nb-workers"] = base["nb-workers"] - f
                    params["learning-rate"] = lr
                    params["momentum-nesterov"] = nesterov
                    jobs.submit(
                        f"{ds}-average-n_{params['nb-workers']}-lr_{lr}{suffix}",
                        make_command(params))
                    for gar in GARS[:len(GARS) - fm]:
                        for attack, attargs in ATTACKS:
                            for momentum in ("update", "worker"):
                                params = dict(base, dataset=ds)
                                params["learning-rate"] = lr
                                params["nb-decl-byz"] = f
                                params["nb-real-byz"] = f
                                params["gar"] = gar
                                params["attack"] = attack
                                params["attack-args"] = attargs
                                params["momentum-at"] = momentum
                                params["momentum-nesterov"] = nesterov
                                jobs.submit(
                                    f"{ds}-{attack}-{gar}-f_{f}-lr_{lr}"
                                    f"-at_{momentum}{suffix}",
                                    make_command(params))


def submit_cifar(jobs):
    """CIFAR-10/100 grid (the root `reproduce.py::submit_cifar`)."""
    base = {
        "batch-size": 50, "model": "empire-cnn", "loss": "nll",
        "learning-rate-decay": 167, "momentum": 0.99, "l2-regularize": 1e-2,
        "evaluation-delta": 100, "gradient-clip": 5, "nb-steps": 3000,
        "nb-for-study": 1, "nb-for-study-past": 25, "nb-workers": 25,
    }
    for ds, mp in (("cifar10", "cifar100:False"), ("cifar100", "cifar100:True")):
        for f, fm in ((11, 1), (5, 0)):
            for lr, dd in ((0.01, 1500), (0.001, 3000)):
                for nesterov in (False, True):
                    suffix = "-nesterov" if nesterov else ""
                    params = dict(base, dataset=ds)
                    params["model-args"] = mp
                    params["nb-workers"] = base["nb-workers"] - f
                    params["learning-rate"] = lr
                    params["learning-rate-decay-delta"] = dd
                    params["momentum-nesterov"] = nesterov
                    jobs.submit(
                        f"{ds}-average-n_{params['nb-workers']}-lr_{lr}{suffix}",
                        make_command(params))
                    for gar in GARS[:len(GARS) - fm]:
                        for attack, attargs in ATTACKS:
                            for momentum in ("update", "worker"):
                                params = dict(base, dataset=ds)
                                params["model-args"] = mp
                                params["learning-rate"] = lr
                                params["learning-rate-decay-delta"] = dd
                                params["nb-decl-byz"] = f
                                params["nb-real-byz"] = f
                                params["gar"] = gar
                                params["attack"] = attack
                                params["attack-args"] = attargs
                                params["momentum-at"] = momentum
                                params["momentum-nesterov"] = nesterov
                                jobs.submit(
                                    f"{ds}-{attack}-{gar}-f_{f}-lr_{lr}"
                                    f"-at_{momentum}{suffix}",
                                    make_command(params))


def submit_faults(jobs, data_dir):
    """Fault-resilience grid (the root `reproduce.py::submit_faults`): the
    smoke-scale MNIST line under Krum with generated fault plans of
    increasing rate, written once into `<data_dir>/fault-plans/` (the
    port's `FaultPlan.generate`, byte-identical to the JAX package's)."""
    from byzantinemomentum_tpu_torch.faults import FaultPlan

    base = {
        "batch-size": 16, "model": "simples-full", "loss": "nll",
        "momentum": 0.9, "evaluation-delta": 10, "nb-steps": 30,
        "nb-for-study": 9, "nb-for-study-past": 3, "nb-workers": 9,
        "batch-size-test": 32, "batch-size-test-reps": 2,
        "learning-rate": 0.5, "gar": "krum", "nb-decl-byz": 2,
    }
    plan_dir = data_dir / "fault-plans"
    plan_dir.mkdir(parents=True, exist_ok=True)
    for rate in FAULT_RATES:
        params = dict(base)
        if rate > 0.0:
            plan = FaultPlan.generate(
                nb_workers=base["nb-workers"], nb_steps=base["nb-steps"],
                rates={"straggler": rate, "drop_worker": rate,
                       "corrupt_gradient": rate / 2},
                seed=int(rate * 10000))
            plan_path = plan_dir / f"rate_{rate}.json"
            plan.save(plan_path)
            params["fault-plan"] = str(plan_path)
        jobs.submit(f"mnist-faults-krum-r_{rate}", make_command(params))


def submit_smoke(jobs):
    """Tiny sanity grid, not the paper's (the root
    `reproduce.py::submit_smoke`), with the health columns on."""
    base = {
        "batch-size": 16, "model": "simples-full", "loss": "nll",
        "momentum": 0.9, "evaluation-delta": 2, "nb-steps": 4,
        "nb-for-study": 9, "nb-for-study-past": 3, "nb-workers": 9,
        "batch-size-test": 32, "batch-size-test-reps": 2,
        "learning-rate": 0.5, "health": True,
    }
    f = 2
    params = dict(base)
    params["nb-workers"] = base["nb-workers"] - f
    params["nb-for-study"] = params["nb-workers"]
    jobs.submit(f"mnist-average-n_{params['nb-workers']}-lr_0.5",
                make_command(dict(params, dataset="mnist")))
    for gar in ("median", "krum"):
        for momentum in ("update", "worker"):
            params = dict(base, dataset="mnist", gar=gar)
            params["nb-decl-byz"] = f
            params["nb-real-byz"] = f
            params["attack"] = "empire"
            params["attack-args"] = "factor:1.1"
            params["momentum-at"] = momentum
            jobs.submit(f"mnist-empire-{gar}-f_{f}-lr_0.5-at_{momentum}",
                        make_command(params))


def submit_appendix(jobs):
    """The appendix's WRN-28-10 grid (the root
    `reproduce-appendix.py::submit`)."""
    base = {
        "batch-size": 20,
        "model": "wide_resnet-Wide_ResNet",
        "model-args": ("depth:28", "widen_factor:10", "dropout_rate:0.3",
                       "num_classes:10"),
        "learning-rate-schedule": "0.02,8000,0.004,16000,0.0008",
        "gradient-clip": 5, "loss": "crossentropy", "momentum": 0.99,
        "momentum-nesterov": True, "l2-regularize": 5e-4,
        "evaluation-delta": 100, "nb-steps": 20000, "nb-for-study": 1,
        "nb-for-study-past": 1, "nb-workers": 11,
    }
    for ds in ("cifar10",):
        for f, fm in ((4, 1), (2, 0)):
            params = dict(base, dataset=ds)
            params["nb-workers"] = base["nb-workers"] - f
            jobs.submit(f"{ds}-average-n_{params['nb-workers']}-lr_pow-nesterov",
                        make_command(params))
            for gar in APPENDIX_GARS[:len(APPENDIX_GARS) - fm]:
                for attack, attargs in ATTACKS:
                    for momentum in ("update", "worker"):
                        params = dict(base, dataset=ds)
                        params["nb-decl-byz"] = f
                        params["nb-real-byz"] = f
                        params["gar"] = gar
                        params["attack"] = attack
                        params["attack-args"] = attargs
                        params["momentum-at"] = momentum
                        jobs.submit(
                            f"{ds}-{attack}-{gar}-f_{f}-lr_pow"
                            f"-at_{momentum}-nesterov",
                            make_command(params))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m byzantinemomentum_tpu_torch.reproduce")
    parser.add_argument("--data-directory", type=str, default="results-data")
    parser.add_argument("--devices", type=str, default="cuda",
                        help="Comma-separated devices ('cuda', "
                             "'cuda:<index>', or 'cpu' by name), one job "
                             "slot each")
    parser.add_argument("--supercharge", type=int, default=1,
                        help="Concurrent runs per device")
    parser.add_argument("--subset", type=str, default="all",
                        choices=("smoke", "faults", "mnist", "cifar",
                                 "appendix", "all"))
    args = parser.parse_args(argv)

    exit_trigger, exit_is_requested = utils.onetime(None)
    signal.signal(signal.SIGINT, lambda *_: exit_trigger())
    signal.signal(signal.SIGTERM, lambda *_: exit_trigger())

    data_dir = pathlib.Path(args.data_directory)
    jobs = Jobs(data_dir, devices=args.devices.split(","),
                supercharge=args.supercharge,
                seeds=(1,) if args.subset in ("smoke", "faults")
                else DEFAULT_SEEDS)
    with utils.Context("experiments"):
        if args.subset == "smoke":
            submit_smoke(jobs)
        if args.subset == "faults":
            submit_faults(jobs, data_dir)
        if args.subset in ("mnist", "all"):
            submit_mnist(jobs)
        if args.subset in ("cifar", "all"):
            submit_cifar(jobs)
        if args.subset == "appendix":
            submit_appendix(jobs)
        jobs.wait(exit_is_requested)
    return 130 if exit_is_requested() else 0


if __name__ == "__main__":
    sys.exit(main())
