"""Run every judged-config harness; one JSON line each + a summary line.

Each config runs in its own process, one at a time, so only one process
holds the GPU; this parent never imports JAX. Exits non-zero when any
config fails."""
import json
import subprocess
import sys


def main():
    results, failed = [], []
    for c in (1, 2, 3, "3b", 4, 5):
        proc = subprocess.run(
            [sys.executable, "-m", f"bench.config{c}"],
            capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.startswith("{"):
                print(line)
                results.append(json.loads(line))
        if proc.returncode != 0:
            failed.append(f"config{c}")
            print(json.dumps({"config": f"config{c}", "error":
                              proc.stderr.strip()[-400:]}))
    print(json.dumps({"summary": {r["config"] + ":" + r["metric"]:
                                  r["value"] for r in results},
                      "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
