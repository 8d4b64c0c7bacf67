"""POA window-file I/O (copy of ``claragenomicsanalysis_tpu/io/windows.py``):
blank-line-separated blocks of reads, one read per line."""


def read_windows(path: str, max_windows: int | None = None) -> list[list[str]]:
    windows: list[list[str]] = []
    cur: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                if cur:
                    windows.append(cur)
                    cur = []
                if max_windows and len(windows) >= max_windows:
                    return windows
            else:
                cur.append(line)
    if cur:
        windows.append(cur)
    return windows


def write_windows(windows: list[list[str]], path: str) -> None:
    with open(path, "w") as f:
        for w in windows:
            for seq in w:
                f.write(seq + "\n")
            f.write("\n")
