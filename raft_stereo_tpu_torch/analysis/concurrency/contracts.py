"""graftlock contract registries — the explicit, reviewed lists the GC
checkers match against (the GL002/GL006 registry discipline applied to
concurrency: the checker never guesses, the registry is the contract and
drifting from it is the finding).

The port's own copy: it keeps the JAX package's registries and adds the
card's host waits.  Stdlib-only; importable without torch like the rest
of ``analysis/``.
"""

from __future__ import annotations

import re

# -- GC202: Future lifecycle ------------------------------------------------

#: Call-name tails / store-target attrs that are REGISTERED Future
#: drains: handing a fresh Future to one of these transfers the
#: resolve-on-every-path obligation to machinery whose stop() provably
#: drains queued Futures (the drain contract, reviewed per entry).
#:
#: - "put_nowait": the scheduler admission queue (service.submit);
#:   stop() drains the queue and resolves every parked Future.
FUTURE_DRAINS = frozenset({"put_nowait"})

#: Constructor names that mint a one-shot Future.
FUTURE_FACTORIES = frozenset({"Future", "concurrent.futures.Future"})

# -- GC203: blocking calls under a held lock --------------------------------

#: Exact canonical names that always block.
BLOCKING_CANONICAL = frozenset({
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
    "socket.create_connection",
})

#: Attribute tails that block regardless of receiver.
BLOCKING_TAILS = frozenset({
    "sleep",        # time.sleep / clock.sleep — a FakeClock sleep still
                    # serializes every tick behind the held lock
    "wait",         # Event.wait / Condition.wait / Popen.wait
    "result",       # Future.result — the canonical caller-deadlock
    "recv", "accept", "connect", "sendall", "communicate",
    "invoke",       # session.invoke: a device program under a host lock
    "synchronize",  # torch.cuda.synchronize / Event / Stream.synchronize:
                    # the host parks until the card drains
    # torch.distributed's blocking collectives (parallel/comm.py,
    # parallel/mesh.py, engine/train.py): every rank parks until the
    # slowest arrives.
    "barrier", "all_reduce", "all_gather", "all_gather_object",
    "broadcast", "broadcast_object_list", "batch_isend_irecv",
})

# ``.item()``, ``.cpu()``, ``.tolist()`` and ``.numpy()`` wait for the card
# when their tensor lives there, and are plain host work when it does not;
# the AST cannot tell which, so they are left out of the registry.

#: Attribute tails that block only in their no-positional-arg form —
#: ``q.get()`` / ``q.get(timeout=...)`` blocks, ``d.get(k, v)`` doesn't;
#: ``t.join()`` / ``t.join(5)`` blocks, ``sep.join(parts)`` doesn't.
BLOCKING_TAILS_NOARG = frozenset({"get", "join"})


def is_blocking_call(canonical: str, n_pos_args: int,
                     first_arg_is_number: bool) -> bool:
    """Judge one call site by its alias-resolved dotted name + arg shape."""
    if canonical in BLOCKING_CANONICAL:
        return True
    tail = canonical.split(".")[-1]
    if tail in BLOCKING_TAILS:
        return True
    if tail in BLOCKING_TAILS_NOARG:
        return n_pos_args == 0 or (n_pos_args == 1 and first_arg_is_number)
    return False


# -- GC204: sinks / IO under a held lock ------------------------------------

#: A lock whose NAME declares it a dedicated IO/sink serializer is
#: allowed to cover IO — that is its whole job (obs/tracing.py's
#: ``_sink_lock``, serve/cache.py's ``_disk_lock`` are the pattern:
#: sink writes get their OWN lock so the admission
#: lock never waits on a disk).
IO_LOCK_NAME_RE = re.compile(r"(sink|disk|io|file|spill|write)", re.I)

#: Call-name tails that invoke a registered callback/sink.
SINK_TAILS = re.compile(r"(^|_)(sink|sinks|callback|callbacks|hook|hooks)"
                        r"$|^emit$|^on_[a-z_]+$")

#: IO call names (canonical) that must not run under a non-IO lock.
IO_CANONICAL = frozenset({
    "open", "os.write", "json.dump", "pickle.dump", "np.save",
    "numpy.save", "shutil.copyfile", "os.replace", "os.rename",
})


def is_sink_call(canonical: str) -> bool:
    if canonical in IO_CANONICAL:
        return True
    tail = canonical.split(".")[-1]
    return bool(SINK_TAILS.search(tail))


def is_io_lock(lock_key: str) -> bool:
    attr = lock_key.rsplit(".", 1)[-1].rsplit("::", 1)[-1]
    return bool(IO_LOCK_NAME_RE.search(attr))


# -- GC205: lock-held helper discipline -------------------------------------

LOCKED_HELPER_RE = re.compile(r"^_\w*_locked$")

# -- GC206: thread lifecycle ------------------------------------------------

#: Directories whose Thread() starts need a reachable join/stop path.
THREADED_DIRS = ("serve/", "obs/")

# -- calls the AST cannot resolve ------------------------------------------

#: ``(caller file suffix, called attribute) -> ((file suffix, class,
#: function), ...)``: the repo functions a call reaches when its callee is
#: a value the AST cannot type, reviewed per entry.
#:
#: - ``serve/session.py``'s ``prog.fn(...)`` / ``p.fn(...)``: a serving
#:   program (a closure ``build_program`` returns) runs the model, whose
#:   kernel wrappers resolve their C entry through ``kernels.entry``; the
#:   first launch of a kernel builds and loads it under the build lock,
#:   so a capture (under the program's lock and ``_ENV_LOCK``) takes it.
DYNAMIC_CALLS = {
    ("serve/session.py", "fn"): (("kernels.py", "", "entry"),),
}

# -- scope ------------------------------------------------------------------

#: GC202 scope: Futures minted under these path segments.
FUTURE_DIRS = ("serve/",)


def in_dirs(relpath: str, dirs) -> bool:
    return any(f"/{d}" in f"/{relpath}" for d in dirs)
