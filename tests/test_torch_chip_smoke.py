"""``chip_smoke.py``'s exits on a host without a card: it fails, prints no
result, and leaves no process behind, both from the checkout and alone in
a directory; and ``stop_children`` ends multiprocessing's resource tracker
and every other child before the script exits, with no semaphore left
for the tracker to clean up."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STOP = """
import json, multiprocessing, os, subprocess, time
from multiprocessing import resource_tracker
import chip_smoke


def ranks_queue():
    # a dropped result queue, as multihost.spawn leaves one, in a cycle
    queue = multiprocessing.get_context("spawn").Queue()
    queue.cycle = queue


if __name__ == "__main__":
    ranks_queue()
    rank = multiprocessing.get_context("spawn").Process(
        target=time.sleep, args=(60,), daemon=True)
    rank.start()
    sleeper = subprocess.Popen(["sleep", "60"])
    tracker = resource_tracker._resource_tracker._pid
    before = sorted(chip_smoke.live_children())
    chip_smoke.stop_children()
    try:
        os.kill(tracker, 0)
        tracker_alive = True
    except ProcessLookupError:
        tracker_alive = False
    print(json.dumps({"before": before, "wanted": sorted(
        [rank.pid, sleeper.pid, tracker]), "tracker_alive": tracker_alive,
        "after": chip_smoke.live_children()}))
"""


def in_group(pgid: int) -> list[str]:
    """Command lines of the processes of process group ``pgid``."""
    found = []
    for entry in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[2]) == pgid:
            found.append(cmd)
    return found


def run_alone_in_group(cwd: str, timeout: float = 300) -> tuple[
        subprocess.CompletedProcess, list[str]]:
    """Run ``python3 chip_smoke.py`` in ``cwd`` as the leader of a new
    process group, and list what is left of the group once it exits (on
    a card too: the whole run takes some 400 s there)."""
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    out, err = proc.communicate(timeout=timeout)
    return (subprocess.CompletedProcess(proc.args, proc.returncode, out, err),
            in_group(proc.pid))


def test_stop_children_ends_the_tracker_and_every_child():
    out = subprocess.run([sys.executable, "-c", _STOP], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "leaked" not in out.stderr and "Error" not in out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["before"] == seen["wanted"]
    assert not seen["tracker_alive"]
    assert seen["after"] == []


def test_without_a_card_it_fails_and_leaves_no_process():
    done, left = run_alone_in_group(REPO)
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr
    assert '"ok"' not in done.stdout
    assert left == []


def test_alone_in_a_directory_it_fails_and_leaves_no_process(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    done, left = run_alone_in_group(str(tmp_path))
    assert done.returncode != 0
    assert '"ok"' not in done.stdout
    assert left == []
