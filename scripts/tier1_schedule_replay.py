"""Where the tier-1 suite's wall time goes, from the junit file of one run
of the tier-1 command (`-n 6 --dist loadfile`; ROADMAP.md, Tier-1).

Usage: python scripts/tier1_schedule_replay.py JUNIT.xml [--workers 6]
       [--jitter 0.05 --samples 200]

Prints the junit time of every test file (the port's `test_torch_*` files
apart), then replays pytest-xdist's loadfile schedule over the run's own
test times: files queue by their number of tests, most first (xdist's
`--loadscope-reorder`, on by default; ties in path order), each worker
starts with one file, takes a second at once, and takes the next file in
the queue whenever two or fewer of its tests remain. The replay counts no
worker start-up or collection, so a real run's wall time lies above it.
With --jitter it replays again with every test time scaled by a uniform
factor in [1 - j, 1 + j] and prints the quantiles of the wall time.
"""
import argparse
import collections
import heapq
import random
import xml.etree.ElementTree as ET


def load(path):
    """{test file: [test seconds, in junit order]}."""
    files = collections.defaultdict(list)
    for case in ET.parse(path).getroot().iter("testcase"):
        files[case.get("classname").split(".")[-1]].append(
            float(case.get("time")))
    return files


def replay(files, workers):
    """(wall, {file: (start, worker)}) of xdist's loadfile schedule."""
    queue = sorted(sorted(files), key=lambda f: -len(files[f]))
    work = {w: collections.deque() for w in range(workers)}
    starts = {}

    def pending(w):
        return sum(len(tests) for _, tests in work[w])

    def assign(w):
        if queue:
            f = queue.pop(0)
            work[w].append((f, collections.deque(files[f])))

    for w in work:
        assign(w)
    for w in work:
        if pending(w) <= 2:
            assign(w)
    events = [(0.0, w) for w in work]
    wall = 0.0
    while events:
        now, w = heapq.heappop(events)
        if not work[w]:
            wall = max(wall, now)
            continue
        f, tests = work[w][0]
        starts.setdefault(f, (now, w))
        done = now + tests.popleft()
        if not tests:
            work[w].popleft()
        if pending(w) <= 2:
            assign(w)
        heapq.heappush(events, (done, w))
    return wall, starts


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("junit")
    p.add_argument("--workers", type=int, default=6)
    p.add_argument("--jitter", type=float, default=0.0)
    p.add_argument("--samples", type=int, default=200)
    a = p.parse_args()
    files = load(a.junit)
    total = {f: sum(t) for f, t in files.items()}
    port = {f: s for f, s in total.items() if f.startswith("test_torch_")}
    print(f"junit {sum(total.values()):.1f} s: port files "
          f"{sum(port.values()):.1f}, the others "
          f"{sum(total.values()) - sum(port.values()):.1f}")
    for f, s in sorted(total.items(), key=lambda kv: -kv[1]):
        print(f"  {s:8.1f} s {len(files[f]):4d} tests  {f}")
    wall, starts = replay(files, a.workers)
    print(f"replayed wall {wall:.1f} s")
    for f, (start, w) in sorted(starts.items(), key=lambda kv: kv[1]):
        if total[f] >= 60:
            print(f"  worker {w} {start:7.1f} -> {start + total[f]:7.1f} s "
                  f"{f}")
    if a.jitter:
        rng = random.Random(0)
        walls = sorted(replay({f: [t * rng.uniform(1 - a.jitter,
                                                   1 + a.jitter)
                                   for t in ts] for f, ts in files.items()},
                              a.workers)[0] for _ in range(a.samples))
        q = [walls[int(x * (len(walls) - 1))] for x in (0, .25, .5, .75, 1)]
        print(f"jitter {a.jitter}: wall min / quartiles / max " +
              " / ".join(f"{v:.1f}" for v in q))


if __name__ == "__main__":
    main()
