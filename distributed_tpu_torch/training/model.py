"""``Model``: a layer stack, its parameters, and the Keras-shaped trainer.

The counterpart of the JAX package's ``training/model.py``: ``build``
creates the parameters from a seed, ``params`` exposes them under the JAX
tree paths, ``compile``/``fit``/``evaluate`` train and score, and
``decode_dtype`` names the KV-cache dtype the serving engine uses.

A model captures the strategy of the ``strategy.scope()`` it is built in
(``SingleDevice`` outside one), and ``compile(strategy=...)`` replaces it.
Under ``DataParallel`` each rank takes its rows of every global batch,
computes the loss as the mean over them, and the gradients are averaged
over the ranks (one all-reduce per dtype) before the optimizer; the
epoch's losses and metric sums are reduced across the ranks at its one
host sync. Every rank builds the same parameters from the same seed.

A model with state (BatchNorm's running statistics) keeps it in buffers,
``state`` exposes them under the JAX state paths and ``load_state`` loads
them. ``fit`` runs the module in train mode (the JAX ``apply``'s
``train=True``) inside its strategy's ``scope()``, so a layer that reduces
over the batch finds the replicas; everything else (``evaluate``, a call
of ``model.module``) runs it in eval mode, as ``train=False``.

A train step is forward, loss, ``torch.autograd.grad`` and the optimizer's
in-place update. Master parameters stay f32; layers built with ``dtype=``
cast them per call, and the gradients come back f32 through the casts, as
in JAX. PyTorch runs eagerly, so there is no jit and no donation; the
per-step loss and metric sums stay on the device and are fetched once per
epoch, as the JAX loop does. The ``compile``/``fit`` options of the JAX
package that are not ported raise ``NotImplementedError``.

``fit`` calls its callbacks (``training.callbacks``) at the JAX package's
hook points and honours its crash-restart contract: after a restoring
``ModelCheckpoint``, ``epochs`` is the total, and the epochs and steps
already done are skipped. With no callbacks a step does what it did
without them: no host sync and no device work is added.
``save_weights``/``load_weights`` write and read the JAX package's HDF5
and npz weight files (``checkpoint``), and ``predict`` gives the logits.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from .. import optim
from ..checkpoint import core as ckpt
from ..device import resolve_device
from ..interop import SEP
from ..ops import losses as losses_lib
from ..ops import metrics as metrics_lib
from ..parallel.strategy import SingleDevice, Strategy, current_strategy
from .history import History
from .progress import ProgressLine


def _index_stream(
    n: int, batch: int, shuffle: bool, seed: Optional[int], start_step: int = 0
):
    """Yield index blocks forever; reshuffles each pass (Keras semantics:
    with steps_per_epoch the cursor carries across epochs). A copy of the
    JAX package's, so shuffled batches come in the same order.

    Each pass's permutation depends only on (seed, pass index), so a
    resumed run (``start_step`` = the restored ``model.step``) continues
    with the batch the interrupted run would have taken next."""
    base = 0 if seed is None else seed
    per_pass = max((n - batch) // batch + 1, 1)
    pass_idx, within = divmod(start_step, per_pass)
    while True:
        rng = np.random.default_rng((base, pass_idx))
        order = rng.permutation(n) if shuffle else np.arange(n)
        starts = range(0, n - batch + 1, batch)
        for start in list(starts)[within:]:
            yield order[start : start + batch]
        within = 0
        pass_idx += 1


def _unported(where: str, **options) -> None:
    """Raise for any option that is set: those paths are not ported yet."""
    for name, value in options.items():
        if value not in (None, False, (), []):
            raise NotImplementedError(f"{where}({name}=...): not yet ported")


class Model:
    """``Model(module, device=None)``: the model on the device of the
    ambient strategy (``strategy.scope()``), else on ``device``, where
    ``None`` is the card; it raises ``RuntimeError`` when there is none
    (pass ``device="cpu"``)."""

    def __init__(self, module, *, device=None):
        self.module = module
        # Scope-wraps-construction: capture the ambient strategy now.
        strategy = current_strategy()
        if strategy is None:
            strategy = SingleDevice(device)
        elif device is not None:
            want = resolve_device(device)
            if want.type != strategy.device.type or want.index not in (
                    None, strategy.device.index):
                raise ValueError(
                    f"Model(device={device!r}) inside the scope of a "
                    f"strategy on {strategy.device}: the strategy places "
                    "the model")
        self.strategy: Strategy = strategy
        self.device = strategy.device
        self.built = False
        self.compiled = False
        self.input_shape: Optional[tuple] = None
        self.step = 0  # global optimizer step (the batch-order cursor)
        self.tx = None
        self.opt_state = None
        self.stop_training = False  # callbacks (EarlyStopping) set this
        self._resumed_step = None  # set by a restoring Checkpointer
        self._seed = 0
        self._decode_dtype = None

    def build(self, input_shape: Sequence[int], seed: int = 0):
        """Create the f32 parameters for an unbatched input shape, drawn
        from a CPU ``torch.Generator`` seeded with ``seed`` (the same
        weights on every device), and move them to ``self.device``."""
        generator = torch.Generator().manual_seed(int(seed))
        self.input_shape = tuple(int(d) for d in input_shape)
        self._seed = int(seed)
        self.module.build(self.input_shape, generator)
        self.module.to(self.device)
        self.module.eval()
        self.built = True
        self._decode_dtype = None
        if self.compiled:
            self.opt_state = self.tx.init(self._param_list())
        return self

    def _require_built(self):
        if not self.built:
            raise RuntimeError("Model not built")

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """``{tree path: parameter}``, paths as in the JAX package
        (``residual_1/main/dense_1/kernel``)."""
        self._require_built()
        return {
            name.replace(".", SEP): p
            for name, p in self.module.named_parameters()
        }

    def _param_list(self):
        return list(self.params.values())

    @property
    def num_params(self) -> int:
        if not self.built:
            raise ValueError("Model not built")
        return sum(p.numel() for p in self.params.values())

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """``{tree path: buffer}``: the model's state (BatchNorm's
        running ``mean`` and ``var``) under the JAX package's state paths
        (``residual/main/batch_norm/mean``); empty for a stateless model."""
        self._require_built()
        return {
            name.replace(".", SEP): b
            for name, b in self.module.named_buffers()
        }

    @staticmethod
    def _check_tree(own, new, what):
        """Raise ValueError unless ``new`` has exactly ``own``'s paths, each
        of its shape."""
        if set(own) != set(new):
            raise ValueError(
                f"{what} paths differ: missing {sorted(set(own) - set(new))}, "
                f"unexpected {sorted(set(new) - set(own))}"
            )
        for path, t in own.items():
            shape = tuple(new[path].shape)
            if shape != tuple(t.shape):
                raise ValueError(f"{path}: shape {shape} != {tuple(t.shape)}")

    @classmethod
    def _copy_into(cls, own, new, what):
        cls._check_tree(own, new, what)
        with torch.no_grad():
            for path, t in own.items():
                t.copy_(torch.as_tensor(new[path]))

    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy ``{tree path: tensor}`` (e.g. ``interop.params_from_jax``)
        into the parameters. Paths and shapes must match exactly."""
        self._copy_into(self.params, params, "parameter")
        self._decode_dtype = None

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy ``{tree path: tensor}`` (e.g. ``interop.state_from_jax``)
        into the state buffers. Paths and shapes must match exactly."""
        self._copy_into(self.state, state, "state")

    def decode_dtype(self) -> torch.dtype:
        """KV-cache / activation dtype for decode: the dtype of the logits
        (there is no precision policy yet), found by one forward pass of
        a single token. Memoized per build/load."""
        self._require_built()
        if self._decode_dtype is None:
            with torch.inference_mode():
                x = torch.zeros((1, 1), dtype=torch.int64, device=self.device)
                self._decode_dtype = self.module(x).dtype
        return self._decode_dtype

    # ---------------------------------------------------------------- compile
    def compile(
        self,
        optimizer="sgd",
        loss="sparse_categorical_crossentropy",
        metrics: Iterable = ("accuracy",),
        grad_clip: Optional[float] = None,
        gradient_accumulation_steps: Optional[int] = None,
        head_chunks: Optional[int] = None,
        steps_per_execution: Optional[int] = None,
        precision=None,
        strategy=None,
        **optimizer_kwargs,
    ):
        """Set the optimizer (a name, with ``optimizer_kwargs`` for its
        constructor, or an ``optim`` instance), the loss (a name, e.g.
        ``"pallas_sparse_categorical_crossentropy"``, or a callable) and the
        metrics. ``strategy`` (a ``parallel.Strategy``) replaces the one
        captured at construction and moves a built model to its device. A
        built model's optimizer state starts afresh, as in JAX. Clipping,
        accumulation, the chunked head, multi-step execution, precision
        policies and ``strategy="auto"`` are kept for call parity with the
        JAX package and raise ``NotImplementedError``."""
        _unported(
            "compile", grad_clip=grad_clip,
            gradient_accumulation_steps=gradient_accumulation_steps,
            head_chunks=head_chunks, steps_per_execution=steps_per_execution,
            precision=precision, strategy=strategy == "auto",
        )
        if strategy is not None:
            if not isinstance(strategy, Strategy):
                raise ValueError(
                    "strategy must be None or a parallel.Strategy instance; "
                    f"got {strategy!r}")
            self.strategy = strategy
            self.device = strategy.device
            if self.built:
                self.module.to(self.device)
        self.tx = optim.get(optimizer, **optimizer_kwargs)
        self.loss_fn = losses_lib.get(loss)
        self.metric_fns = [(metrics_lib.name_of(m), metrics_lib.get(m))
                           for m in metrics]
        self.compiled = True
        if self.built:
            self.opt_state = self.tx.init(self._param_list())
        return self

    # -------------------------------------------------------- learning rate
    def set_learning_rate(self, lr: float):
        """Change the learning rate of the current optimizer state (held
        there as an f32 hyperparameter, as optax.inject_hyperparams does)."""
        if self.opt_state is None:
            raise RuntimeError("compile() and build() the model first")
        self.opt_state = optim.set_hyperparam(self.opt_state,
                                              "learning_rate", lr)
        return self

    def get_learning_rate(self) -> float:
        if self.opt_state is None:
            raise RuntimeError("compile() and build() the model first")
        return optim.get_hyperparam(self.opt_state, "learning_rate")

    # ------------------------------------------------------------- train step
    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _train_step(self, x, y):
        """One optimizer step on a device batch: returns the loss (a
        device scalar) and each metric's (sum, count)."""
        params = self._param_list()
        with self.strategy.scope():
            logits = self.module(x)
            loss = self.loss_fn(logits, y)
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
        grads = self.strategy.reduce_gradients(grads)
        self.tx.update(params, grads, self.opt_state)
        with torch.no_grad():
            mvals = {name: fn(logits.detach(), y)
                     for name, fn in self.metric_fns}
        return loss.detach(), mvals

    # -------------------------------------------------------------------- fit
    def fit(
        self,
        x,
        y=None,
        batch_size: int = 32,
        epochs: int = 1,
        steps_per_epoch: Optional[int] = None,
        validation_data=None,
        validation_steps: Optional[int] = None,
        shuffle: bool = True,
        verbose: int = 1,
        initial_epoch: int = 0,
        seed: Optional[int] = None,
        callbacks: Sequence = (),
        grad_accum: Optional[int] = None,
    ) -> History:
        """Train on host arrays ``(x, y)``: ``batch_size`` rows per step
        (the global batch: under ``DataParallel`` each rank takes its
        share, and it must divide evenly), ``steps_per_epoch`` steps per
        epoch (default ``len(x) // batch_size``), batches drawn in the JAX
        package's order (``shuffle``, ``seed``), continuing from
        ``model.step``. Returns a ``History`` of per-epoch means.

        ``callbacks`` (``training.callbacks``) are called as in the JAX
        package: ``on_train_begin`` (before the batch order is set, so a
        restoring ``ModelCheckpoint`` moves it), then per epoch
        ``on_epoch_begin``, ``on_batch_end(model, step, {"loss": device
        scalar})`` after each step (the global batch's loss: under
        ``DataParallel`` the ranks' losses are averaged for it, one
        all-reduce a step when there are callbacks) and
        ``on_epoch_end(model, epoch, logs)``, and ``on_train_end(model,
        history)``; a callback that sets ``model.stop_training`` ends the
        run after the step or epoch.
        After a restore (``model._resumed_step``) with ``initial_epoch``
        0, ``epochs`` is the total: the finished epochs are skipped and
        the interrupted one runs its remaining steps.
        ``validation_data=(x, y)`` is evaluated after each epoch and
        logged as ``val_<name>``. A batch iterator (as ``x`` or as
        ``validation_data``; ``validation_steps`` goes with it) and
        ``grad_accum`` are not ported yet and raise."""
        if not self.compiled:
            raise RuntimeError("Call compile() before fit()")
        if y is None:
            raise NotImplementedError(
                "fit(x) from a batch iterator: not yet ported")
        if hasattr(validation_data, "__next__"):
            raise NotImplementedError(
                "fit(validation_data=<batch iterator>): not yet ported")
        _unported("fit", grad_accum=grad_accum)
        x = np.asarray(x)
        y = np.asarray(y)
        if not self.built:
            self.build(x.shape[1:], seed=0 if seed is None else seed)
        n = x.shape[0]
        if batch_size > n:
            raise ValueError(f"batch_size {batch_size} > dataset size {n}")
        if steps_per_epoch is None:
            steps_per_epoch = n // batch_size
        self.strategy.local_batch_size(batch_size)  # replica divisibility
        history = History()
        callbacks = list(callbacks)
        self.stop_training = False
        self._resumed_step = None
        for cb in callbacks:
            cb.on_train_begin(self)
        # After on_train_begin: a restoring ModelCheckpoint may have moved
        # self.step, and the batch order continues from it.
        stream = _index_stream(n, batch_size, shuffle, seed,
                               start_step=self.step)
        resume_offset = 0
        if self._resumed_step is not None and initial_epoch == 0:
            initial_epoch, resume_offset = divmod(self._resumed_step,
                                                  steps_per_epoch)
        self._resumed_step = None
        self.module.train()
        try:
            self._fit_epochs(x, y, batch_size, epochs, steps_per_epoch,
                             verbose, initial_epoch, resume_offset, stream,
                             history, callbacks, validation_data)
        finally:
            self.module.eval()
        for cb in callbacks:
            cb.on_train_end(self, history)
        return history

    def _fit_epochs(self, x, y, batch_size, epochs, steps_per_epoch, verbose,
                    initial_epoch, resume_offset, stream, history, callbacks,
                    validation_data):
        for epoch in range(initial_epoch, epochs):
            t0 = time.perf_counter()
            for cb in callbacks:
                cb.on_epoch_begin(self, epoch)
            losses = []
            msums: Dict[str, list] = {name: [] for name, _ in self.metric_fns}
            epoch_steps = steps_per_epoch - resume_offset
            resume_offset = 0
            bar = None
            if verbose == 1:
                bar = ProgressLine(epoch_steps,
                                   prefix=f"Epoch {epoch + 1}/{epochs}: ")
            reps = self.strategy.num_replicas_in_sync
            done = 0
            while done < epoch_steps:
                idx = next(stream)
                loss, mvals = self._train_step(self.strategy.put_batch(x[idx]),
                                               self.strategy.put_batch(y[idx]))
                self.step += 1
                done += 1
                losses.append(loss)
                for name, _ in self.metric_fns:
                    msums[name].append(mvals[name])
                if callbacks:
                    # The global batch's loss on every rank, as in JAX.
                    logs = {"loss": loss if reps == 1 else
                            self.strategy.all_reduce_sum(loss.clone()) / reps}
                    for cb in callbacks:
                        cb.on_batch_end(self, self.step, logs)
                if bar is not None:
                    bar.update(done)
                if self.stop_training:
                    break
            if bar is not None:
                bar.close()
            # One host sync per epoch: every loss and metric sum at once,
            # summed over the replicas (each loss is its rank's mean, so the
            # losses are divided by their number; each rank scores as many
            # elements, so the counts are multiplied by it).
            vec = self.strategy.all_reduce_sum(torch.cat(
                [torch.stack(losses).to(torch.float32)]
                + [torch.stack([p[0] for p in pairs]).to(torch.float32)
                   for pairs in msums.values()])).cpu().numpy()
            logs = {"loss": float(np.mean(vec[:done] / reps))}
            for i, (name, pairs) in enumerate(msums.items()):
                s = vec[(i + 1) * done:(i + 2) * done]
                c = np.float32(sum(float(p[1]) for p in pairs) * reps)
                logs[name] = float(np.float32(s.sum()) / max(c, 1.0))
            if validation_data is not None:
                val = self.evaluate(validation_data[0], validation_data[1],
                                    batch_size=batch_size, verbose=0)
                logs.update({f"val_{k}": v for k, v in val.items()})
            dt = time.perf_counter() - t0
            history.record(epoch, logs)
            for cb in callbacks:
                cb.on_epoch_end(self, epoch, logs)
            if self.stop_training:
                epochs = epoch + 1  # for the epoch counter printed below
            if verbose:
                parts = " - ".join(f"{k}: {v:.4f}" for k, v in logs.items())
                print(f"Epoch {epoch + 1}/{epochs} - "
                      f"{batch_size * done} samples - {dt:.2f}s "
                      f"({dt / done * 1000:.1f}ms/step) - {parts}")
            if self.stop_training:
                break

    # --------------------------------------------------------------- evaluate
    def evaluate(self, x, y=None, batch_size: int = 32, verbose: int = 1,
                 steps: Optional[int] = None) -> Dict[str, float]:
        """Loss and metrics over arrays ``(x, y)``, as per-element means
        (an LM's loss is the mean over every token, as in training). The
        last batch may be partial; it is scored as it is, with no padding
        (PyTorch needs no static shapes), which the JAX package's masked
        padding computes the same. Under ``DataParallel`` each rank scores
        its rows of every batch (``batch_size`` must divide evenly) and the
        sums are reduced across the ranks at the end. The module runs in
        eval mode and is left in the mode it was in (``fit`` validates
        between its epochs)."""
        if y is None:
            raise NotImplementedError(
                "evaluate(x) from a batch iterator: not yet ported")
        _unported("evaluate", steps=steps)
        if not (self.built and self.compiled):
            raise RuntimeError("Model must be built and compiled")
        x = np.asarray(x)
        y = np.asarray(y)
        n = x.shape[0]
        lo, hi = self.strategy.row_range(batch_size)
        per_ex = losses_lib.get_per_example(self.loss_fn)
        sums, counts = [], []  # per batch: [loss, metric...]; sums on device
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        was_training = self.module.training
        self.module.eval()
        try:
            with torch.inference_mode():
                for start in range(0, n, batch_size):
                    rows = slice(min(start + lo, n), min(start + hi, n))
                    if rows.start == rows.stop:  # the batch ends before us
                        sums.append([zero] * (1 + len(self.metric_fns)))
                        counts.append([0.0] * (1 + len(self.metric_fns)))
                        continue
                    xb = self._to_device(x[rows])
                    yb = self._to_device(y[rows])
                    logits = self.module(xb)
                    valid = float(yb.numel())
                    if per_ex is not None:
                        loss_sum = per_ex(logits, yb).sum()
                    else:
                        loss_sum = self.loss_fn(logits, yb) * valid
                    row_sums, row_counts = [loss_sum], [valid]
                    for name, fn in self.metric_fns:
                        scores = metrics_lib.per_example(fn)
                        if scores is not None:
                            sc = scores(logits, yb)
                            row_sums.append(sc.sum())
                            row_counts.append(float(sc.numel()))
                        else:
                            msum, mcount = fn(logits, yb)
                            row_sums.append(msum)
                            row_counts.append(float(mcount))
                    sums.append([v.to(torch.float32) for v in row_sums])
                    counts.append(row_counts)
        finally:
            self.module.train(was_training)
        k = 1 + len(self.metric_fns)
        vec = self.strategy.all_reduce_sum(torch.cat([
            torch.stack([v for row in sums for v in row]).to(torch.float64),
            torch.tensor([c for row in counts for c in row],
                         dtype=torch.float64, device=self.device),
        ])).cpu().numpy().reshape(2, -1, k)
        totals = [sum(float(v) for v in vec[0, :, j]) for j in range(k)]
        dens = [sum(float(c) for c in vec[1, :, j]) for j in range(k)]
        out = {"loss": totals[0] / max(dens[0], 1.0)}
        for j, (name, _) in enumerate(self.metric_fns, start=1):
            out[name] = totals[j] / max(dens[j], 1.0)
        if verbose:
            parts = " - ".join(f"{k}: {v:.4f}" for k, v in out.items())
            print(f"Evaluate - {x.shape[0]} samples - {parts}")
        return out


    # ---------------------------------------------------------------- predict
    def predict(self, x, batch_size: int = 32,
                steps: Optional[int] = None) -> np.ndarray:
        """The logits of every row of the host array ``x``, as f32 numpy,
        ``batch_size`` rows per forward pass in eval mode (the last batch
        partial). Under ``DataParallel`` every rank computes all rows, so
        each returns the whole result, as in the JAX package. Up to 16
        batches of logits stay on the device before they are fetched. A
        batch iterator (and ``steps``, which goes with it) is not ported
        yet and raises."""
        self._require_built()
        if hasattr(x, "__next__"):
            raise NotImplementedError(
                "predict(<batch iterator>): not yet ported")
        _unported("predict", steps=steps)
        x = np.asarray(x)
        self.strategy.local_batch_size(batch_size)
        fetched, pending = [], []
        was_training = self.module.training
        self.module.eval()
        try:
            with torch.inference_mode():
                for start in range(0, x.shape[0], batch_size):
                    xb = self._to_device(x[start:start + batch_size])
                    pending.append(self.module(xb).to(torch.float32))
                    if len(pending) >= 16:
                        fetched.append(pending.pop(0).cpu().numpy())
                fetched += [o.cpu().numpy() for o in pending]
        finally:
            self.module.train(was_training)
        return np.concatenate(fetched, axis=0)

    # ---------------------------------------------------------------- weights
    def save_weights(self, path):
        """Write the parameters and the state (BatchNorm's running
        statistics) as ``{"params", "state"}`` to an HDF5 file, or npz when
        ``path`` ends in ``.npz``: the JAX package's ``save_weights``
        files. Chief-only; ``checkpoint.Checkpointer`` keeps training
        checkpoints."""
        self._require_built()
        tree = {"params": self.params, "state": self.state}
        path = str(path)
        if path.endswith(".npz"):
            return ckpt.save_npz(path, tree)
        return ckpt.export_hdf5(path, tree)

    def load_weights(self, path):
        """Load a ``save_weights`` file of either package (HDF5, or npz by
        its suffix), or a bare parameter tree (``export_hdf5(path,
        params)``; the state is left as it is then). Paths and shapes are
        checked before anything is copied. A compiled model's optimizer
        state starts afresh, as in the JAX package."""
        if not self.built:
            raise RuntimeError(
                "Build the model first (model.build(input_shape)) so the "
                "loaded weights have parameters to go into")
        path = str(path)
        if path.endswith(".npz"):
            tree, _ = ckpt.load_npz(path)
        else:
            tree, _ = ckpt.import_hdf5(path)
        if "params" in tree and set(tree) <= {"params", "state"}:
            # A stateless model's empty state leaves no entry in the file.
            params, state = tree["params"], tree.get("state")
        else:
            params, state = tree, None
        params = ckpt.flatten_tree(params)
        self._check_tree(self.params, params, "parameter")
        if state is not None:
            state = ckpt.flatten_tree(state)
            self._check_tree(self.state, state, "state")
        self.load_params(params)
        if state is not None:
            self.load_state(state)
        if self.compiled:
            self.opt_state = self.tx.init(self._param_list())
        return self


__all__ = ["Model"]
