# Keras-shaped model API: build %>% compile %>% fit, the distributedtpu R
# package's functions over the PyTorch/CUDA port. R hands doubles over as
# float64 arrays; the port's fit/evaluate/predict take them as float32, as
# the JAX package does.

#' The reference's exact MNIST CNN (README.md:58-68).
#' @export
mnist_cnn <- function(num_classes = 10L) {
  dtpu()$models$mnist_cnn(num_classes = as.integer(num_classes))
}

#' @export
cifar_cnn <- function(num_classes = 10L) {
  dtpu()$models$cifar_cnn(num_classes = as.integer(num_classes))
}

#' @export
resnet50 <- function(num_classes = 1000L, small_inputs = FALSE) {
  dtpu()$models$resnet50(num_classes = as.integer(num_classes),
                         small_inputs = small_inputs)
}

#' Wrap a module into a trainable model. Call inside with_strategy_scope()
#' to distribute (scope-wraps-construction, README.md:134); the strategy then
#' places it. Outside one, `device = NULL` is the GPU (it stops without one)
#' and `device = "cpu"` the CPU.
#' @export
dtpu_model <- function(module, name = NULL, device = NULL) {
  m <- dtpu()$Model(module, name = name, device = device)
  class(m) <- c("dtpu_model", class(m))
  m
}

#' @export
compile <- function(object, ...) UseMethod("compile")

#' Configure loss/optimizer/metrics (README.md:70-73, 145-151).
#' @export
compile.dtpu_model <- function(object,
                               optimizer = "sgd",
                               loss = "sparse_categorical_crossentropy",
                               metrics = c("accuracy"),
                               learning_rate = NULL,
                               ...) {
  if (!is.null(learning_rate) && is.character(optimizer)) {
    optimizer <- dtpu()$optim$get(optimizer,
                                  learning_rate = as.numeric(learning_rate))
  }
  object$compile(optimizer = optimizer, loss = loss,
                 metrics = as.list(metrics), ...)
  invisible(object)
}

#' @export
fit <- function(object, ...) UseMethod("fit")

#' Train; returns a history whose metrics are R vectors
#' (`result$metrics$accuracy`, the shape the reference's Spark closure reads
#' at README.md:220).
#' @export
fit.dtpu_model <- function(object, x, y,
                           batch_size = 32L,
                           epochs = 1L,
                           steps_per_epoch = NULL,
                           validation_data = NULL,
                           verbose = 1L,
                           callbacks = list(),
                           ...) {
  h <- object$fit(
    x, y,
    batch_size = as.integer(batch_size),
    epochs = as.integer(epochs),
    steps_per_epoch = if (is.null(steps_per_epoch)) NULL
                      else as.integer(steps_per_epoch),
    validation_data = validation_data,
    verbose = as.integer(verbose),
    callbacks = callbacks,
    ...
  )
  hist <- list(metrics = lapply(h$history, unlist), model = object)
  class(hist) <- "dtpu_history"
  hist
}

#' @export
print.dtpu_history <- function(x, ...) {
  for (k in names(x$metrics)) {
    cat(k, ": ", paste(signif(x$metrics[[k]], 4), collapse = " "), "\n",
        sep = "")
  }
  invisible(x)
}

#' @export
evaluate <- function(object, ...) UseMethod("evaluate")

#' @export
evaluate.dtpu_model <- function(object, x, y, batch_size = 32L, ...) {
  res <- object$evaluate(x, y, batch_size = as.integer(batch_size), ...)
  lapply(res, as.numeric)
}

#' @export
predict_on_batch <- function(object, x, batch_size = 32L) {
  object$predict(x, batch_size = as.integer(batch_size))
}

#' @export
summary_model <- function(object) object$summary()

#' Save the trained model as HDF5 — the reference's model-exchange format
#' (save_model_hdf5, README.md:237). Rank-0-only under SPMD. Captures
#' params AND model state (BatchNorm running statistics): the reference's
#' save_model_hdf5 captures everything needed to score
#' (README.md:236-247), so a reloaded resnet50 must infer with its trained
#' statistics, not reset ones. Delegates to Model$save_weights, whose
#' {params, state} file layout Model$load_weights round-trips.
#' @export
save_model_hdf5 <- function(object, filepath) {
  object$save_weights(filepath)
  invisible(filepath)
}

#' Load an HDF5 model saved by save_model_hdf5 into a built model.
#' Also accepts bare-params interchange files (the pre-round-5 layout and
#' other producers): Model$load_weights detects which layout it is reading.
#' @export
load_model_hdf5 <- function(object, filepath) {
  object$load_weights(filepath)
  invisible(object)
}

# ---- callbacks ------------------------------------------------------------

#' Periodic checkpoints + crash-restart resume (the capability the
#' reference's own logs flag as missing, README.md:400).
#' @export
model_checkpoint_callback <- function(directory, save_freq = "epoch",
                                      keep = 3L, restore = FALSE) {
  if (is.numeric(save_freq)) save_freq <- as.integer(save_freq)
  dtpu()$callbacks$ModelCheckpoint(directory, save_freq = save_freq,
                                   keep = as.integer(keep), restore = restore)
}

#' @export
early_stopping_callback <- function(monitor = "loss", patience = 0L,
                                    min_delta = 0) {
  dtpu()$callbacks$EarlyStopping(monitor = monitor,
                                 patience = as.integer(patience),
                                 min_delta = as.numeric(min_delta))
}

#' @export
csv_logger_callback <- function(path) dtpu()$callbacks$CSVLogger(path)

#' Per-epoch learning-rate schedule: `schedule(epoch)` or
#' `schedule(epoch, lr)` (0-based epoch) returns the new rate, applied
#' without recompiling (named optimizers carry their hyperparameters in
#' the optimizer state). The R closure is normalized to the two-argument
#' form here: Python's arity fallback catches TypeError only, which a
#' reticulate-wrapped R closure's "unused argument" error is not.
#' @export
learning_rate_scheduler_callback <- function(schedule, verbose = 0L) {
  wrapped <- if (length(formals(schedule)) >= 2) {
    schedule
  } else {
    function(epoch, lr) schedule(epoch)
  }
  dtpu()$callbacks$LearningRateScheduler(wrapped,
                                         verbose = as.integer(verbose))
}

#' Multiply the learning rate by `factor` after `patience` epochs without
#' `monitor` improving; mirrors keras::callback_reduce_lr_on_plateau.
#' @export
reduce_lr_on_plateau_callback <- function(monitor = "loss", factor = 0.5,
                                          patience = 3L, min_delta = 1e-4,
                                          min_lr = 0, cooldown = 0L,
                                          verbose = 0L) {
  dtpu()$callbacks$ReduceLROnPlateau(monitor = monitor,
                                     factor = as.numeric(factor),
                                     patience = as.integer(patience),
                                     min_delta = as.numeric(min_delta),
                                     min_lr = as.numeric(min_lr),
                                     cooldown = as.integer(cooldown),
                                     verbose = as.integer(verbose))
}

#' Chief-only per-epoch TensorBoard scalars.
#' @export
tensorboard_callback <- function(log_dir) {
  dtpu()$callbacks$TensorBoard(log_dir)
}

#' Keras-style weight round-trip (params AND BatchNorm running stats);
#' writes npz instead of HDF5 when the path ends in .npz.
#' @export
save_model_weights_hdf5 <- function(object, filepath) {
  object$save_weights(filepath)
  invisible(filepath)
}

#' Load weights saved by save_model_weights_hdf5 into a built model.
#' @export
load_model_weights_hdf5 <- function(object, filepath) {
  object$load_weights(filepath)
  invisible(object)
}
