"""An object-store ``model_dir``: the port's counterpart of
``deepfm_tpu/checkpoint/remote.py``.

The reference checkpoints to an S3 ``model_dir`` (README.md:63), with
SageMaker doing the transfers.  :class:`RemoteCheckpointer` wraps the
port's :class:`~deepfm_tpu_torch.checkpoint.ckpt.Checkpointer` with a
local staging mirror of any URL the S3-wire client
(``data/object_store.py``) reaches, with JAX's design:

* **save**: the step is written into the staging directory as usual
  (``state.pt``, plus ``rows-<i>.pt`` on a grid); a background uploader
  then PUTs the step's files to ``<url>/<step>/...`` and a
  ``_COMMIT_<step>`` marker object last: only marker-bearing steps are
  complete, so a crash mid-upload never yields a half checkpoint.
  Transient upload errors retry with bounded backoff; a step that
  exhausts its retries is logged on the next ``save`` and re-enqueued
  there (while it is still staged and unmarked), while
  ``wait_until_finished``, ``close`` and ``save(block=True)`` raise.
* **restore / latest_step**: the remote committed steps are listed; a
  step missing from staging is downloaded first, then restored through
  the local checkpointer.
* **retention**: remote steps outside the local ``max_to_keep`` window are
  deleted, marker first, so a partial delete reads as "not committed".
* **start**: staging leftovers without a remote marker (a crash mid-upload,
  or a remote ``clear_existing_model``) are dropped, so they never come
  back as ``latest_step``.
* **single writer**: a URL ``model_dir`` at a world size above 1 raises,
  as JAX's does: the mirror would upload one process's files only.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import tempfile
import threading

from ..data.object_store import get_store, is_url, join_url
from ..utils.retry import RetryPolicy
from .ckpt import Checkpointer

_MARKER = "_COMMIT_"


def _staging_dir_for(url: str) -> str:
    h = hashlib.sha1(url.encode()).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(), f"deepfm_torch_ckpt_stage_{h}")


class RemoteCheckpointer:
    """:class:`Checkpointer`'s interface over an object-store URL."""

    def __init__(self, url: str, *, max_to_keep: int = 3, staging_dir: str | None = None,
                 upload_retries: int = 3, retry_backoff_secs: float = 0.2, ctx=None):
        world = ctx.world_size if ctx is not None else int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise ValueError(
                "a remote (URL) model_dir is single-process only: each rank would "
                "mirror and upload its own files; a grid or data-parallel run needs a "
                "model_dir every rank sees (checkpoint/remote.py)")
        self._url = url.rstrip("/")
        self._store = get_store()
        self._staging = staging_dir or _staging_dir_for(self._url)
        os.makedirs(self._staging, exist_ok=True)
        self._max_to_keep = max_to_keep
        committed = set(self._remote_steps())
        for name in os.listdir(self._staging):
            if name.isdigit() and int(name) not in committed:
                shutil.rmtree(os.path.join(self._staging, name), ignore_errors=True)
        self._local = Checkpointer(self._staging, max_to_keep=max_to_keep, ctx=ctx)
        self._uploader: threading.Thread | None = None
        self._upload_err: BaseException | None = None
        self._upload_policy = RetryPolicy(
            max_attempts=max(1, int(upload_retries)),
            base_delay_secs=float(retry_backoff_secs),
            max_delay_secs=max(float(retry_backoff_secs), 30.0))
        # steps whose upload exhausted its retries, re-enqueued on the next save
        self._failed_steps: set[int] = set()

    @property
    def last_save(self) -> dict | None:
        return self._local.last_save

    @property
    def last_restore(self) -> dict | None:
        return self._local.last_restore

    # -- remote index --------------------------------------------------------

    def _remote_steps(self) -> list[int]:
        steps = []
        for url in self._store.list_prefix(self._url + "/"):
            name = url.rsplit("/", 1)[-1]
            if name.startswith(_MARKER) and name[len(_MARKER):].isdigit():
                steps.append(int(name[len(_MARKER):]))
        return sorted(steps)

    # -- upload side ---------------------------------------------------------

    def _join_uploader(self) -> None:
        if self._uploader is not None:
            self._uploader.join()
            self._uploader = None
        if self._upload_err is not None:
            err, self._upload_err = self._upload_err, None
            raise err

    def _upload_step(self, step: int) -> None:
        self._local.wait_until_finished()  # the files must be on disk
        self._store.upload_tree(os.path.join(self._staging, str(step)),
                                join_url(self._url, str(step)))
        self._store.put(join_url(self._url, f"{_MARKER}{step}"), b"ok")
        # retention mirrors the local window, marker first
        keep = set(self._local.all_steps())
        for s in self._remote_steps():
            if s not in keep:
                self._store.delete(join_url(self._url, f"{_MARKER}{s}"))
                self._store.delete_prefix(join_url(self._url, str(s)) + "/")

    def save(self, state, *, block: bool = False) -> bool:
        """Save into staging, then upload on a thread (``block``: here).
        A previous upload's failure is logged and its step re-enqueued."""
        try:
            self._join_uploader()
        except Exception as e:
            logging.getLogger(__name__).warning(
                "remote checkpoint upload failed (step re-enqueued, retried on this "
                "save): %s", e)
        saved = self._local.save(state, block=block)
        steps = self._pending_steps()
        if saved:
            step = int(state.step)
            steps = [s for s in steps if s != step] + [step]
        if steps:
            self._uploader = threading.Thread(target=self._try_upload_many, args=(steps,),
                                              daemon=True)
            self._uploader.start()
            if block:
                self._join_uploader()
        return saved

    def _pending_steps(self) -> list[int]:
        """Failed uploads still worth retrying: still staged, still unmarked."""
        if not self._failed_steps:
            return []
        self._failed_steps &= set(self._local.all_steps())
        if self._failed_steps:
            try:
                self._failed_steps -= set(self._remote_steps())
            # da:allow[swallowed-exception] listing outage: re-uploading a committed step is idempotent waste, losing one is not
            except Exception:
                pass
        return sorted(self._failed_steps)

    def _try_upload_many(self, steps: list[int]) -> None:
        for step in steps:
            try:
                self._upload_policy.call(lambda s=step: self._upload_step(s),
                                         classify=lambda e: True)
                self._failed_steps.discard(step)
            except BaseException as e:
                self._upload_err = e
                self._failed_steps.add(step)

    def wait_until_finished(self) -> None:
        self._local.wait_until_finished()
        self._join_uploader()

    # -- read side -----------------------------------------------------------

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return sorted(set(self._local.all_steps()) | set(self._remote_steps()))

    def step_dir(self, step: int) -> str:
        """Step ``step``'s local directory, downloaded into staging first."""
        if step not in self._local.all_steps():
            dest = os.path.join(self._staging, str(step))
            tmp = dest + ".download"
            shutil.rmtree(tmp, ignore_errors=True)
            self._store.download_tree(join_url(self._url, str(step)), tmp)
            os.replace(tmp, dest)
        return self._local.step_dir(step)

    def restore(self, target, step: int | None = None):
        self._join_uploader()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore at {self._url}")
        self.step_dir(step)
        return self._local.restore(target, step)

    def close(self) -> None:
        self._join_uploader()
        self._local.close()


def make_checkpointer(directory, **kwargs) -> Checkpointer | RemoteCheckpointer:
    """A :class:`Checkpointer` for a local directory, a
    :class:`RemoteCheckpointer` for an object-store URL."""
    if is_url(str(directory)):
        return RemoteCheckpointer(str(directory), **kwargs)
    return Checkpointer(directory, **kwargs)


def maybe_clear(directory, enabled: bool) -> None:
    """``clear_existing_model``: delete the model directory first (an
    object-store URL: every object under it)."""
    if not enabled:
        return
    if is_url(str(directory)):
        get_store().delete_prefix(str(directory).rstrip("/") + "/")
    elif os.path.isdir(directory):
        shutil.rmtree(directory)
