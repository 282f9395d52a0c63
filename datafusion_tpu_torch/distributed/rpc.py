"""JSON-over-TCP control plane for multi-process clusters.

Port of ``datafusion_tpu/distributed/rpc.py`` (host logic).  Replaces
Ballista's tonic gRPC services (SchedulerGrpc,
ballista/rust/core/proto/ballista.proto:890-899) with a line-delimited
JSON protocol over TCP: the thin host-side control path.  The data plane
stays out of band: shuffle spill files on the shared filesystem.

Wire format: one JSON object per line.
  request : {"method": str, "params": {...}}
  response: {"ok": true, "result": ...} | {"ok": false, "error": str}

Methods mirror the gRPC service: register_table_schema, execute_query,
poll_work, task_completed, task_failed, get_job_status, tables, ping.

Run a scheduler:  python -m datafusion_tpu_torch.distributed.rpc scheduler \
                      --port 50050 --work-dir /shared/dir
Run an executor:  python -m datafusion_tpu_torch.distributed.rpc executor \
                      --scheduler HOST:50050 --work-dir /shared/dir [--device cpu]

``--device`` picks the executor's device (default: the card; with no card
the executor raises at start).  The scheduler role takes the option too,
for one command line for both roles, and ignores it: it plans on the host
and never opens a device.
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import threading

from ..errors import DataFusionError
from . import serde
from .exchange import TableStore
from .scheduler import Scheduler
from .state import FileKV, SchedulerState

# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            line = self.rfile.readline()
            if not line:
                return
            try:
                req = json.loads(line)
                method = req["method"]
                params = req.get("params", {})
                fn = getattr(self.server.service, f"rpc_{method}", None)
                if fn is None:
                    raise DataFusionError(f"unknown method {method}")
                result = fn(**params)
                resp = {"ok": True, "result": result}
            except Exception as e:  # noqa: BLE001 — serialize to the client
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class SchedulerService:
    """RPC facade over Scheduler (SchedulerGrpc equivalent)."""

    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler

    def rpc_ping(self):
        return "pong"

    def rpc_register_table_schema(self, name, schema):
        self.scheduler.register_table_schema(name, serde.schema_from_dict(schema))
        return True

    def rpc_execute_query(self, plan):
        return self.scheduler.execute_query(plan)

    def rpc_poll_work(self, executor_id, can_accept_task=True, running=None):
        return self.scheduler.poll_work(executor_id, can_accept_task, running=running)

    def rpc_task_completed(self, executor_id, job_id, stage_id, partition, stats):
        self.scheduler.task_completed(executor_id, job_id, stage_id, partition, stats)
        return True

    def rpc_task_failed(self, executor_id, job_id, stage_id, partition, error):
        self.scheduler.task_failed(executor_id, job_id, stage_id, partition, error)
        return True

    def rpc_get_job_status(self, job_id):
        out = self.scheduler.get_job_status(job_id)
        if "final_schema" in out:
            out["final_schema"] = serde.schema_to_dict(out["final_schema"])
        return out


def serve_scheduler(port: int, work_dir: str, target_partitions: int = 4):
    """Blocking scheduler server over a shared-filesystem state dir."""
    state = SchedulerState(FileKV(f"{work_dir}/_state"), work_dir=work_dir)
    sched = Scheduler(state, work_dir=work_dir, target_partitions=target_partitions)
    srv = _Server(("0.0.0.0", port), _Handler)
    srv.service = SchedulerService(sched)
    return srv


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class RpcSchedulerClient:
    """Drop-in for the in-proc Scheduler from the executor/context side."""

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self.addr = (host, int(port))
        self._sock = None
        self._lock = threading.Lock()
        self.work_dir = ""  # set by callers that know the shared dir

    def _connect(self):
        s = socket.create_connection(self.addr, timeout=30)
        self._sock = s
        self._rf = s.makefile("rb")
        self._wf = s.makefile("wb")

    def call(self, method: str, **params):
        with self._lock:
            if self._sock is None:
                self._connect()
            msg = json.dumps({"method": method, "params": params}) + "\n"
            try:
                self._wf.write(msg.encode())
                self._wf.flush()
                line = self._rf.readline()
            except (BrokenPipeError, ConnectionResetError):
                self._connect()
                self._wf.write(msg.encode())
                self._wf.flush()
                line = self._rf.readline()
            if not line:
                raise DataFusionError("scheduler connection closed")
            resp = json.loads(line)
        if not resp["ok"]:
            raise DataFusionError(f"rpc {method}: {resp['error']}")
        return resp["result"]

    # Scheduler-compatible surface used by Executor / client code
    def register_table_schema(self, name, schema):
        self.call("register_table_schema", name=name, schema=serde.schema_to_dict(schema))

    def execute_query(self, plan_dict):
        return self.call("execute_query", plan=plan_dict)

    def poll_work(self, executor_id, can_accept_task=True, running=None):
        return self.call(
            "poll_work",
            executor_id=executor_id,
            can_accept_task=can_accept_task,
            running=running,
        )

    def task_completed(self, executor_id, job_id, stage_id, partition, stats):
        self.call(
            "task_completed",
            executor_id=executor_id,
            job_id=job_id,
            stage_id=stage_id,
            partition=partition,
            stats=stats,
        )

    def task_failed(self, executor_id, job_id, stage_id, partition, error):
        self.call(
            "task_failed",
            executor_id=executor_id,
            job_id=job_id,
            stage_id=stage_id,
            partition=partition,
            error=error,
        )

    def get_job_status(self, job_id):
        out = self.call("get_job_status", job_id=job_id)
        if "final_schema" in out:
            out["final_schema"] = serde.schema_from_dict(out["final_schema"])
        return out


class _RemoteStateShim:
    """Executor.start() calls scheduler.state.register_executor; over RPC
    the heartbeat inside poll_work covers registration."""

    def __init__(self, client):
        self.client = client

    def register_executor(self, executor_id, meta=None):
        self.client.poll_work(executor_id, can_accept_task=False)


def run_executor(
    scheduler_addr: str,
    work_dir: str,
    executor_id: str,
    mesh_devices: int | None = None,
    device=None,
):
    """Blocking executor process against a remote scheduler (Ballista's
    executor main, ballista/rust/executor) on ``device`` (None: the card).
    With ``mesh_devices`` the executor runs every stage SPMD over a mesh of
    that many logical shards instead of the single-device operators."""
    from .executor import Executor

    client = RpcSchedulerClient(scheduler_addr)
    client.work_dir = work_dir
    client.state = _RemoteStateShim(client)
    store = TableStore(spill_dir=f"{work_dir}/_tables", device=device)
    ex = Executor(executor_id, client, store, mesh_devices=mesh_devices, device=device)
    ex.start()
    return ex


# ---------------------------------------------------------------------------
# CLI entry
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(prog="datafusion-tpu-distributed")
    sub = ap.add_subparsers(dest="role", required=True)
    s = sub.add_parser("scheduler")
    s.add_argument("--port", type=int, default=50050)
    s.add_argument("--work-dir", required=True)
    s.add_argument("--partitions", type=int, default=4)
    s.add_argument("--device", default=None,
                   help="ignored: the scheduler plans on the host and opens no device")
    e = sub.add_parser("executor")
    e.add_argument("--scheduler", required=True)
    e.add_argument("--work-dir", required=True)
    e.add_argument("--id", default=None)
    e.add_argument(
        "--mesh-devices",
        type=int,
        default=None,
        help="run stages SPMD over a mesh of N logical shards on the "
        "executor's device; default: the single-device operators",
    )
    e.add_argument("--device", default=None,
                   help="the executor's device, e.g. cpu or cuda:0 (default: the card)")
    args = ap.parse_args(argv)

    if args.role == "scheduler":
        srv = serve_scheduler(args.port, args.work_dir, args.partitions)
        print(f"scheduler listening on :{args.port}, work dir {args.work_dir}", flush=True)
        srv.serve_forever()
    else:
        import os
        import time

        ex_id = args.id or f"executor-{os.getpid()}"
        ex = run_executor(
            args.scheduler, args.work_dir, ex_id, mesh_devices=args.mesh_devices,
            device=args.device,
        )
        print(f"{ex_id} polling {args.scheduler}", flush=True)
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            ex.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
