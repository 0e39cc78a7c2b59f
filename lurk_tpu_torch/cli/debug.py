"""Interactive debug viewer for the eval call tree.

Reference: /root/reference/src/core/cli/debug.rs (ratatui TUI) +
repl.rs:350-430 (entry formatting). Entry format matches the reference:
`?d: expr` when evaluation of `expr` is pushed at depth d, ` d: expr
↦ out` when it pops, `!d: expr ↦ out` on a memoization hit.

The viewer is a raw-terminal pager with the reference's key map:
Up/Down move focus (Ctrl: scroll viewport; PageUp/PageDown likewise),
Left/Right jump to the previous/next entry at the same depth (Ctrl:
previous/next breakpoint), Space/Backspace next/previous breakpoint,
Home/End first/last entry, q/Esc quit. Runs on plain ANSI + termios -
no UI dependency. Key input and screen output are injectable so the
navigation loop is unit-testable without a TTY.
"""

from __future__ import annotations

import copy
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional


@dataclass
class FormattedDebugEntry:
    dbg_depth: int
    formatted: str


class FormattedDebugData:
    """Entries + depth index + breakpoint list (debug.rs:12-58)."""

    def __init__(self, entries: List[FormattedDebugEntry],
                 breakpoints: List[int]):
        self.entries = entries
        self.breakpoints = breakpoints
        self.dbg_depth_map: Dict[int, List[int]] = {}
        for i, e in enumerate(entries):
            self.dbg_depth_map.setdefault(e.dbg_depth, []).append(i)

    def is_empty(self) -> bool:
        return not self.entries

    def _same_depth(self, idx: int) -> List[int]:
        return self.dbg_depth_map[self.entries[idx].dbg_depth]

    def next_eq_depth_idx(self, idx: int) -> Optional[int]:
        return next((i for i in self._same_depth(idx) if i > idx), None)

    def prev_eq_depth_idx(self, idx: int) -> Optional[int]:
        return next((i for i in reversed(self._same_depth(idx)) if i < idx),
                    None)

    def next_breakpoint_idx(self, idx: int) -> Optional[int]:
        return next((i for i in self.breakpoints if i > idx), None)

    def prev_breakpoint_idx(self, idx: int) -> Optional[int]:
        return next((i for i in reversed(self.breakpoints) if i < idx), None)


def format_debug_data(repl, limit: Optional[int] = None) -> FormattedDebugData:
    """Egress every recorded eval query (up to `limit` entries) and render
    the reference's entry strings. One scratch query record serves all
    egressions (the reference's tmp_queries_for_egression pattern)."""
    from ..core.zstore import ZPtr
    from ..lair.execute import execute_by_name

    toplevel = repl.toplevel
    eval_idx = toplevel.func_index["eval"]
    queries_tmp = copy.deepcopy(repl.queries)
    queries_tmp.func_queries = [
        m.to_index_map() if hasattr(m, "to_index_map") else m
        for m in queries_tmp.func_queries]
    hash4_idx = toplevel.func_index["hash4"]
    hash5_idx = toplevel.func_index["hash5"]

    def egress(tag: int, ptr: int) -> str:
        out = execute_by_name(toplevel, "egress", [int(tag), int(ptr)],
                              queries_tmp)
        zptr = ZPtr(int(out[0]), tuple(int(x) for x in out[1:9]))
        repl.zstore.memoize_dag(zptr.tag, zptr.digest,
                                queries_tmp.inv_func_queries[hash4_idx],
                                queries_tmp.inv_func_queries[hash5_idx])
        return repl.fmt(zptr)

    eval_queries = repl.queries.func_queries[eval_idx]
    if hasattr(eval_queries, "to_index_map"):
        eval_queries = eval_queries.to_index_map()
    raw_entries = repl.queries.debug_data.entries
    if limit is not None:
        raw_entries = raw_entries[:limit]
    entries = []
    for entry in raw_entries:
        inp, result = eval_queries.get_index(entry.query_idx)
        expr = egress(inp[0], inp[1])
        if entry.kind == "push":
            text = f"?{entry.dbg_depth}: {expr}"
        else:
            out = result.output
            res = egress(out[0], out[1]) if out is not None else "<?>"
            mark = "!" if entry.kind == "memoized" else " "
            text = f"{mark}{entry.dbg_depth}: {expr} ↦ {res}"
        entries.append(FormattedDebugEntry(entry.dbg_depth, text))
    return FormattedDebugData(entries, list(repl.queries.debug_data.breakpoints))


# -- interactive loop (debug.rs:60-184) ---------------------------------------

_CSI_KEYS = {"A": "up", "B": "down", "C": "right", "D": "left",
             "H": "home", "F": "end", "5~": "pageup", "6~": "pagedown",
             "1;5A": "ctrl-up", "1;5B": "ctrl-down",
             "1;5C": "ctrl-right", "1;5D": "ctrl-left"}


def _read_keys_tty() -> Iterable[str]:
    """Decode terminal escape sequences into key names. A bare Esc quits
    immediately (select() distinguishes it from an escape sequence whose
    continuation bytes arrive together); SS3 sequences (ESC O ...) from
    application-keypad terminals map like their CSI equivalents."""
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)

    def pending() -> bool:
        return bool(select.select([fd], [], [], 0.01)[0])

    try:
        tty.setraw(fd)
        while True:
            c = sys.stdin.read(1)
            if c == "q" or c == "\x03":  # q / Ctrl-C
                yield "quit"
            elif c == "\x1b":
                if not pending():
                    yield "quit"  # bare Esc
                    continue
                nxt = sys.stdin.read(1)
                if nxt not in ("[", "O"):
                    yield "quit"
                    continue
                seq = ""
                while True:
                    ch = sys.stdin.read(1)
                    seq += ch
                    if ch.isalpha() or ch == "~":
                        break
                yield _CSI_KEYS.get(seq, "")
            elif c == " ":
                yield "space"
            elif c in ("\x7f", "\x08"):
                yield "backspace"
            else:
                yield ""
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def debug_mode(data: FormattedDebugData, keys: Optional[Iterable[str]] = None,
               write=None, height: int = 0) -> int:
    """Run the viewer; returns the final focus index. `keys`/`write`/
    `height` are injectable for tests; the defaults drive a real TTY."""
    if data.is_empty():
        raise ValueError("No data to debug")
    tty_mode = keys is None
    if tty_mode:
        import shutil
        height = height or max(shutil.get_terminal_size().lines - 1, 3)
        keys = _read_keys_tty()
        write = sys.stdout.write
    else:
        height = height or 10
        write = write or (lambda s: None)

    entries = data.entries
    last = len(entries) - 1
    start = 0
    focus = 0

    def render():
        if tty_mode:
            write("\x1b[2J\x1b[H")  # clear + home
        end = min(start + height, len(entries))
        for i in range(start, end):
            line = entries[i].formatted
            if i == focus:
                write(f"\x1b[7m{line}\x1b[0m\r\n" if tty_mode
                      else f">{line}\n")
            else:
                write(f"{line}\r\n" if tty_mode else f" {line}\n")
        return end - 1

    display_end = render()
    for key in keys:
        prev_focus = focus
        if key == "quit":
            break
        elif key == "down":
            focus = min(last, focus + 1)
        elif key == "ctrl-down" or key == "pagedown":
            start = min(last, start + 1)
        elif key == "up":
            focus = max(0, focus - 1)
        elif key == "ctrl-up" or key == "pageup":
            start = max(0, start - 1)
        elif key == "right":
            focus = data.next_eq_depth_idx(focus) or focus
        elif key == "left":
            nxt = data.prev_eq_depth_idx(focus)
            focus = focus if nxt is None else nxt
        elif key in ("ctrl-right", "space"):
            focus = data.next_breakpoint_idx(focus) or focus
        elif key in ("ctrl-left", "backspace"):
            nxt = data.prev_breakpoint_idx(focus)
            focus = focus if nxt is None else nxt
        elif key == "home":
            focus = 0
        elif key == "end":
            focus = last
        if focus != prev_focus:
            if focus < start or display_end <= focus:
                start = focus
        display_end = render()
    return focus
