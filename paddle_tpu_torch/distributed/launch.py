"""Multi-process launcher: `python -m paddle_tpu_torch.distributed.launch
train.py` (the port of `paddle_tpu/distributed/launch.py`; ref
python/paddle/distributed/fleet/launch.py:208,260,334 launch_collective,
launch_utils.py:57 Cluster/Pod/Trainer, :435 the TrainerProc watch
loop).

One process per rank, as PyTorch runs a job. The cluster model and the
per-rank environment are the JAX package's (PADDLE_TRAINER_ID,
PADDLE_CURRENT_ENDPOINT, PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
COORDINATOR_ADDRESS, PROCESS_ID, NUM_PROCESSES), plus what a rank of the
port needs to find its card: FLAGS_selected_gpus (the trainer's card on
its host), PADDLE_LOCAL_RANK and PADDLE_LOCAL_SIZE (the ranks on its
host). `env.init_parallel_env` turns COORDINATOR_ADDRESS into the TCP
store of `torch.distributed`, hosted by rank 0. The rank-0 pod also
hosts the host-collective store (`gloo.KVStore`) on the coordinator's
port + 1 (PADDLE_GLOO_HTTP_ENDPOINT), for `fleet.util`.

A worker that dies tears the pod down; `--max_restarts N` restarts the
whole local pod up to N times (a collective job cannot take back a lone
rank). Parameter-server mode (`--server_num`) is not ported.
"""
import argparse
import os
import signal
import subprocess
import sys
import time


class Trainer:
    def __init__(self, rank, endpoint, devices):
        self.rank = rank
        self.endpoint = endpoint
        self.devices = devices


class Pod:
    """One job's trainers and its coordinator (ref launch_utils.py:57)."""

    def __init__(self, trainers, coordinator):
        self.trainers = trainers
        self.coordinator = coordinator


def get_cluster(nproc_per_node, start_port=36777, ips="127.0.0.1",
                nnodes=None):
    """nproc_per_node ranks on EACH host in --ips (total = per_node x
    hosts). `nnodes` must match the host count when both are given; with
    a single host entry it replicates it (nodes simulated on one host,
    each with its own port range)."""
    hosts = [h for h in ips.split(",") if h]
    if nnodes and nnodes != len(hosts):
        if len(hosts) != 1:
            raise ValueError(
                f"--nnodes {nnodes} does not match --ips ({ips}, "
                f"{len(hosts)} hosts): give one ip (replicated) or exactly "
                f"nnodes ips")
        hosts = hosts * nnodes
    trainers = []
    for hi, host in enumerate(hosts):
        for i in range(nproc_per_node):
            rank = hi * nproc_per_node + i
            trainers.append(Trainer(
                rank, f"{host}:{start_port + rank}", [i]))
    return Pod(trainers, f"{hosts[0]}:{start_port - 1}")


def _local_addresses():
    """Addresses that mean 'this host': POD_IP, the hostname, loopback."""
    import socket
    addrs = {"127.0.0.1", "localhost", "0.0.0.0"}
    pod_ip = os.environ.get("POD_IP")
    if pod_ip:
        addrs.add(pod_ip)
    try:
        hn = socket.gethostname()
        addrs.add(hn)
        addrs.add(socket.gethostbyname(hn))
    except OSError:
        pass
    return addrs


def local_trainers(pod):
    """This host's slice of the pod: only these ranks are started here."""
    addrs = _local_addresses()
    mine = [t for t in pod.trainers if t.endpoint.split(":")[0] in addrs]
    if mine:
        return mine
    pod_hosts = {t.endpoint.split(":")[0] for t in pod.trainers}
    if len(pod_hosts) == 1:
        return pod.trainers
    raise RuntimeError(
        f"cannot identify this host among pod hosts {sorted(pod_hosts)} "
        f"(local addresses: {sorted(addrs)}); set POD_IP to this host's "
        f"ip from --ips so each host starts only its own ranks")


def _rank_env(pod, trainer, nproc, training_script_args):
    env = dict(os.environ)
    # every node runs the same number of ranks, on cards 0..n-1
    per_node = 1 + max(t.devices[0] for t in pod.trainers)
    env.update({
        # reference contract (launch_utils.py:258 get_proc_env)
        "PADDLE_TRAINER_ID": str(trainer.rank),
        "PADDLE_CURRENT_ENDPOINT": trainer.endpoint,
        "PADDLE_TRAINERS_NUM": str(nproc),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(
            t.endpoint for t in pod.trainers),
        # the JAX package's coordinator contract: the rendezvous address
        "COORDINATOR_ADDRESS": pod.coordinator,
        "PROCESS_ID": str(trainer.rank),
        "NUM_PROCESSES": str(nproc),
        # the rank's card on its host
        "FLAGS_selected_gpus": str(trainer.devices[0]),
        "PADDLE_LOCAL_RANK": str(trainer.devices[0]),
        "PADDLE_LOCAL_SIZE": str(per_node),
    })
    return env


def launch_procs(pod, script, script_args, nproc, log_dir=None,
                 max_restarts=0):
    """Start one process per local trainer and watch them; on a failure
    restart the whole local pod (up to `max_restarts` times) or tear it
    down. Returns the pod's exit code."""
    mine = local_trainers(pod)
    attempts = 0
    while True:
        rc = _run_pod_once(pod, mine, script, script_args, nproc, log_dir,
                           attempt=attempts)
        if rc == 0 or attempts >= max_restarts:
            return rc
        attempts += 1
        sys.stderr.write(
            f"pod failed (exit {rc}); elastic restart "
            f"{attempts}/{max_restarts}\n")


def _run_pod_once(pod, mine, script, script_args, nproc, log_dir, attempt=0):
    procs = []
    logs = []
    # the host-collective store: the rank-0 pod hosts it on the
    # coordinator's port + 1, so every pod computes the same endpoint; a
    # PADDLE_GLOO_HTTP_ENDPOINT from the scheduler wins
    kv = None
    kv_ep = os.environ.get("PADDLE_GLOO_HTTP_ENDPOINT")
    if kv_ep is None and pod.coordinator:
        host, cport = pod.coordinator.rsplit(":", 1)
        kv_ep = f"{host}:{int(cport) + 1}"
        if mine and mine[0].rank == 0:
            from .gloo import KVStore
            kv = KVStore(port=int(cport) + 1)
    try:
        for t in mine:
            env = _rank_env(pod, t, nproc, script_args)
            env["PADDLE_RESTART_ATTEMPT"] = str(attempt)
            if kv_ep:
                env["PADDLE_GLOO_HTTP_ENDPOINT"] = kv_ep
            cmd = [sys.executable, "-u", script] + list(script_args)
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                suffix = f".r{attempt}" if attempt else ""
                f = open(os.path.join(log_dir,
                                      f"workerlog.{t.rank}{suffix}"), "w")
                logs.append(f)
                p = subprocess.Popen(cmd, env=env, stdout=f, stderr=f)
            else:
                p = subprocess.Popen(cmd, env=env)
            procs.append(p)
        ret = 0
        alive = True
        while alive:
            alive = False
            for i, p in enumerate(procs):
                rc = p.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    # a worker died: tear down the pod
                    sys.stderr.write(
                        f"trainer rank {mine[i].rank} failed "
                        f"(exit {rc}); aborting pod\n")
                    ret = rc
                    alive = False
                    break
            if alive:
                time.sleep(0.2)
        return ret if ret else max(
            (p.wait() or 0 for p in procs), default=0)
    finally:
        for q in procs:
            if q.poll() is None:
                q.send_signal(signal.SIGTERM)
        for q in procs:
            try:
                q.wait(30)
            except subprocess.TimeoutExpired:
                q.kill()
                q.wait()
        for f in logs:
            f.close()
        if kv is not None:
            kv.stop()


def main(argv=None):
    parser = argparse.ArgumentParser(
        "paddle_tpu_torch.distributed.launch",
        description="launch a distributed job: one process per rank")
    parser.add_argument("--nproc_per_node", type=int, default=None,
                        help="ranks per node (default: the node's CUDA "
                             "cards, at least 1)")
    parser.add_argument("--nnodes", type=int, default=None,
                        help="number of nodes; with a single --ips entry the "
                             "nodes are simulated on localhost")
    parser.add_argument("--ips", type=str, default="127.0.0.1",
                        help="comma-split host ips (ref launch.py --ips)")
    parser.add_argument("--start_port", type=int, default=36777)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--server_num", type=int, default=0,
                        help="PS mode: number of parameter servers "
                             "(not ported)")
    parser.add_argument("--max_restarts", type=int, default=0,
                        help="elastic: restart the local pod up to N times "
                             "on worker failure")
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    nproc = args.nproc_per_node
    if nproc is None:
        import torch
        nproc = max(1, torch.cuda.device_count())
    if args.server_num:
        return _launch_ps(args, nproc)
    pod = get_cluster(nproc, args.start_port, args.ips, nnodes=args.nnodes)
    return launch_procs(pod, args.training_script,
                        args.training_script_args, len(pod.trainers),
                        args.log_dir, max_restarts=args.max_restarts)


def _launch_ps(args, nproc):
    """Parameter-server mode (ref launch.py launch_ps): the port's PS
    slice is ROADMAP Queue 1 item 5c."""
    raise NotImplementedError(
        "launch --server_num: the parameter-server mode is not ported yet "
        "(ROADMAP Queue 1 item 5c, fleet/{ps,heter,runtime,trainers}.py)")


if __name__ == "__main__":
    sys.exit(main())
