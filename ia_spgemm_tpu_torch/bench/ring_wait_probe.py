"""Probe: how long one stream-ordered signal takes between processes that
share (or do not share) a card, the question the design of K13 across
processes turns on (``parallel/rdma_ring.py``).

Processes on one card are CUDA contexts that time-slice. A kernel that
spins on a neighbour's word holds its slice, so the neighbour can only
answer in a later slice. A stream wait (``cuStreamWaitValue64``) runs no
kernel; whether the card then switches to the waiting context's
neighbours at once is what this measures. NPROC worker processes pass a
token round a ring ROUNDS times: process 0 writes i into process 1's
word and waits until its own word reaches i; process r > 0 waits for i,
then writes i into process r + 1's word. Every write and wait of a
process is enqueued on one stream before any runs, so the host takes no
part; the time of one round (host clock from a barrier to the stream's
end, over ROUNDS rounds) is NPROC signals.

Modes: ``device``, each process's word in its card's memory, shared by
CUDA IPC; ``host``, in pinned host memory shared by the processes (a
POSIX shared-memory page registered with ``cudaHostRegister``), which
the stream polls over PCIe; ``hostwait``, the same words with every wait
made by the host (it polls its own word, then enqueues the next write):
the design that needs no stream wait at all.

    python -m ia_spgemm_tpu_torch.bench.ring_wait_probe

Runs each mode at 2 and 4 processes, ROUNDS rounds, and prints one JSON
line per (mode, processes): us per round and per signal, and each
process's us to enqueue its operations. Needs a card; every process uses
card 0 of those it sees.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import socket
import subprocess
import sys
import time

CU_STREAM_WAIT_VALUE_GEQ = 0x0
CU_STREAM_WRITE_VALUE_DEFAULT = 0x0
CUDA_HOST_REGISTER_PORTABLE_MAPPED = 0x1 | 0x2
PROCS = (2, 4)
ROUNDS = 1000
MODES = ("device", "host", "hostwait")
TIMEOUT_S = 120.0


def libcuda():
    """libcuda's 64-bit stream memory operations through ctypes."""
    lib = ctypes.CDLL("libcuda.so.1")
    for name in ("cuStreamWriteValue64_v2", "cuStreamWaitValue64_v2"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                       ctypes.c_uint]
        fn.restype = ctypes.c_int
    lib.cuMemHostGetDevicePointer_v2.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_void_p, ctypes.c_uint]
    return lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _host_word(lib, path, create):
    """A pinned, device-mapped 8-byte word in the shared page at path:
    (mmap, host address, device address)."""
    import torch
    flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
    fd = os.open(path, flags, 0o600)
    try:
        if create:
            os.ftruncate(fd, mmap.PAGESIZE)
        mm = mmap.mmap(fd, mmap.PAGESIZE)
    finally:
        os.close(fd)
    host = ctypes.addressof(ctypes.c_char.from_buffer(mm))
    _check(torch.cuda.cudart().cudaHostRegister(
        host, mmap.PAGESIZE, CUDA_HOST_REGISTER_PORTABLE_MAPPED),
        "cudaHostRegister")
    dptr = ctypes.c_uint64()
    _check(lib.cuMemHostGetDevicePointer_v2(ctypes.byref(dptr), host, 0),
           "cuMemHostGetDevicePointer")
    return mm, host, dptr.value


def worker(pid, nproc, port, mode, rounds):
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=nproc, rank=pid)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lib = libcuda()
    keep = []
    if mode == "device":
        from torch.multiprocessing.reductions import reduce_tensor
        own = torch.zeros(1, dtype=torch.int64, device=dev)
        torch.cuda.synchronize()
        handles = [None] * nproc
        dist.all_gather_object(handles, reduce_tensor(own))
        fn, args = handles[(pid + 1) % nproc]
        nxt = fn(*args)
        keep += [own, nxt]
        own_addr, nxt_addr, host = own.data_ptr(), nxt.data_ptr(), None
    else:
        paths = [None] * nproc
        mine = f"/dev/shm/ia_k13_probe_{port}_{pid}"
        mm, host, own_addr = _host_word(lib, mine, True)
        dist.all_gather_object(paths, mine)
        mm2, _, nxt_addr = _host_word(lib, paths[(pid + 1) % nproc], False)
        dist.barrier()
        os.unlink(mine)
        keep += [mm, mm2]
    stream = torch.cuda.Stream(dev)
    s = stream.cuda_stream
    seen = ctypes.c_int64.from_address(host) if host else None

    def host_wait(i):
        while seen.value < i:
            pass

    dist.barrier()
    t0 = time.perf_counter()
    for i in range(1, rounds + 1):
        if pid == 0:
            _check(lib.cuStreamWriteValue64_v2(
                s, nxt_addr, i, CU_STREAM_WRITE_VALUE_DEFAULT), "write")
            if mode == "hostwait":
                host_wait(i)
            else:
                _check(lib.cuStreamWaitValue64_v2(
                    s, own_addr, i, CU_STREAM_WAIT_VALUE_GEQ), "wait")
        else:
            if mode == "hostwait":
                host_wait(i)
            else:
                _check(lib.cuStreamWaitValue64_v2(
                    s, own_addr, i, CU_STREAM_WAIT_VALUE_GEQ), "wait")
            _check(lib.cuStreamWriteValue64_v2(
                s, nxt_addr, i, CU_STREAM_WRITE_VALUE_DEFAULT), "write")
    enqueue_us = (time.perf_counter() - t0) * 1e6
    stream.synchronize()
    round_us = (time.perf_counter() - t0) * 1e6 / rounds
    out = [None] * nproc
    dist.all_gather_object(out, enqueue_us)
    if pid == 0:
        print(json.dumps({"ring_wait_probe": {
            "mode": mode, "processes": nproc, "rounds": rounds,
            "us_per_round": round_us, "us_per_signal": round_us / nproc,
            "enqueue_us": out, "card": torch.cuda.get_device_name(dev)}}),
            flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    """The sweep, or with (PID, NPROC, PORT, MODE) one of its workers."""
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        pid, nproc, port = map(int, argv[:3])
        worker(pid, nproc, port, argv[3], ROUNDS)
        return 0
    rc = 0
    for mode in MODES:
        for nproc in PROCS:
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                port = sk.getsockname()[1]
            procs = [subprocess.Popen(
                [sys.executable, "-m", __spec__.name, str(pid), str(nproc),
                 str(port), mode], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
                for pid in range(nproc)]
            outs = []
            try:
                for pr in procs:
                    outs.append(pr.communicate(timeout=TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                outs.append(f"timed out after {TIMEOUT_S} s")
            finally:
                for pr in procs:
                    if pr.poll() is None:
                        pr.kill()
                        pr.wait()
            bad = [pr.returncode for pr in procs if pr.returncode]
            text = "\n".join(outs)
            line = [ln for ln in text.splitlines()
                    if ln.startswith('{"ring_wait_probe"')]
            if bad or not line:
                rc = 1
                print(f"{mode} x {nproc}: failed {bad}\n{text}", flush=True)
            else:
                print(line[0], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
