"""Loopback ports and child output for the port's tests, with every wait
bounded.

A port taken by binding 0 and closing the socket lies in the ephemeral
range (Linux's default starts at 32768), where every loopback client
socket of the suite draws its source port: by the time a rank binds it, or
binds the port after it, a connection may hold it and the bind fails with
``Address already in use``. The ports handed out here lie below that
range, and each one was bound a moment before it is returned."""

import random
import socket
import subprocess
import threading


def free_base(n: int) -> int:
    """A base port below the ephemeral range whose next ``n`` ports bind now."""
    while True:
        # OS entropy: tests reseed the global ``random``, and two workers in
        # one state would draw, and race for, the same base
        base = random.SystemRandom().randrange(20000, 29000)
        try:
            for p in range(base, base + n):
                socket.create_server(("", p)).close()
            return base
        except OSError:
            continue


def free_port() -> int:
    return free_base(1)


def read_line(proc: subprocess.Popen, stderr_path, timeout: float = 60.0) -> str:
    """The first line a child prints on its stdout pipe. A child that exits
    first, or prints nothing within ``timeout`` seconds, is killed and fails
    the test with the stderr it wrote to ``stderr_path``."""
    line = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()),
                              name="read-line", daemon=True)
    reader.start()
    reader.join(timeout)
    if line and line[0]:
        return line[0]
    proc.kill()  # ends the reader's readline too
    proc.wait(timeout=10)
    with open(stderr_path) as f:
        err = f.read()
    raise AssertionError(f"the child printed no line within {timeout} s "
                         f"(exit code {proc.returncode}); its stderr:\n{err}")
