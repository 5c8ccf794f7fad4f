"""Standalone autoscaler daemon: the closed-loop policy thread as an operator
process.

Watches a running router's ``/fleet/slo`` + ``/replicas`` planes and drives
its elastic admin plane (``POST /replicas`` / ``POST /replicas/drain`` /
``DELETE /replicas/{id}``): sustained overload scales up, sustained calm
scales down, a DOWN replica is force-removed and replaced, and overload at
the max envelope pushes a brownout floor to the replicas (shed best-effort
first) instead of letting everyone time out. Every decision is a
flight-recorder event and one JSONL line on stdout.

Replicas are provisioned through a subprocess command template — anything
that starts a serving HTTP plane on ``{host}:{port}`` works::

    python -m paddlenlp_tpu_torch.tools.autoscaler --router 127.0.0.1:8010 \\
        --min 1 --max 4 \\
        --spawn "python -m my_replica_entrypoint --host {host} --port {port}"

Knobs mirror ``AutoscalerPolicy`` (see ``--help``). Ctrl-C drains nothing:
the fleet keeps serving; only the control loop stops. The port's counterpart
of ``tools/autoscaler.py``, with the same flags.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--router", required=True, help="router HOST:PORT")
    ap.add_argument("--spawn", required=True,
                    help="replica launch command template ({host}/{port} substituted)")
    ap.add_argument("--host", default="127.0.0.1", help="bind host for spawned replicas")
    ap.add_argument("--min", type=int, default=1, dest="min_replicas")
    ap.add_argument("--max", type=int, default=4, dest="max_replicas")
    ap.add_argument("--interval", type=float, default=2.0, help="tick seconds")
    ap.add_argument("--up-kv", type=float, default=0.85)
    ap.add_argument("--up-queue", type=float, default=4.0)
    ap.add_argument("--up-burn", type=float, default=10.0)
    ap.add_argument("--down-kv", type=float, default=0.30)
    ap.add_argument("--down-queue", type=float, default=0.5)
    ap.add_argument("--hysteresis-up", type=int, default=2)
    ap.add_argument("--hysteresis-down", type=int, default=5)
    ap.add_argument("--cooldown-up", type=float, default=10.0)
    ap.add_argument("--cooldown-down", type=float, default=30.0)
    ap.add_argument("--step-up", type=int, default=2)
    ap.add_argument("--step-down", type=int, default=1)
    ap.add_argument("--drain-deadline", type=float, default=30.0)
    ap.add_argument("--brownout-level", type=int, default=1,
                    help="brownout floor pushed at the max envelope (0 disables)")
    ap.add_argument("--teardown-on-exit", action="store_true",
                    help="terminate every autoscaler-spawned replica on exit "
                         "(default: leave the fleet serving — only the "
                         "control loop stops)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    from ..serving.router.autoscaler import (
        Autoscaler,
        AutoscalerPolicy,
        SubprocessProvisioner,
    )

    host, _, port = args.router.partition(":")
    if not port:
        print(json.dumps({"error": f"--router must be HOST:PORT, got {args.router!r}"}))
        return 2
    policy = AutoscalerPolicy(
        min_replicas=args.min_replicas, max_replicas=args.max_replicas,
        scale_up_kv_utilization=args.up_kv, scale_up_queue_depth=args.up_queue,
        scale_up_burn_rate=args.up_burn,
        scale_down_kv_utilization=args.down_kv,
        scale_down_queue_depth=args.down_queue,
        hysteresis_up=args.hysteresis_up, hysteresis_down=args.hysteresis_down,
        cooldown_up_s=args.cooldown_up, cooldown_down_s=args.cooldown_down,
        max_step_up=args.step_up, max_step_down=args.step_down,
        drain_deadline_s=args.drain_deadline,
        brownout_push_level=args.brownout_level)
    provisioner = SubprocessProvisioner(args.spawn, host=args.host)
    scaler = Autoscaler((host, int(port)), provisioner, policy=policy,
                        interval_s=args.interval)

    stop = {"flag": False}

    def _sig(_signum, _frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        while not stop["flag"]:
            t0 = time.time()
            try:
                summary = scaler.evaluate_once()
            except Exception as e:
                summary = {"t": t0, "error": repr(e)}
            print(json.dumps(summary), flush=True)
            delay = args.interval - (time.time() - t0)
            if delay > 0:
                time.sleep(delay)
    finally:
        # the docstring contract: a daemon exit stops ONLY the control loop;
        # spawned replicas keep serving (still registered with the router)
        # unless the operator explicitly asked for teardown
        if args.teardown_on_exit:
            provisioner.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
