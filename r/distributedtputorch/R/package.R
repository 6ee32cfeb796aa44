# Package bootstrap: the reticulate bridge to the Python
# `distributed_tpu_torch` package, the PyTorch/CUDA port of
# `distributed_tpu`. The functions are the `distributedtpu` R package's, so a
# script moves over by its library() line; the port's entry points take
# `device = NULL` as the GPU (they stop without one) and `device = "cpu"`
# for the CPU.

.globals <- new.env(parent = emptyenv())

#' Handle to the Python distributed_tpu_torch module (lazy import).
#' @export
dtpu <- function() {
  if (is.null(.globals$dtpu)) {
    .globals$dtpu <- reticulate::import("distributed_tpu_torch",
                                        delay_load = FALSE)
  }
  .globals$dtpu
}

.onLoad <- function(libname, pkgname) {
  # Delay-load so library(distributedtputorch) works before reticulate has
  # selected a Python (the same pattern the R keras package uses).
  .globals$dtpu <- reticulate::import("distributed_tpu_torch",
                                      delay_load = TRUE)
}

#' Install the Python package into the active reticulate environment:
#' run once per machine, then restart the session.
#' @param path path to the source tree (repo root), which holds the port
#' @export
install_distributed_tpu <- function(path = NULL, envname = NULL) {
  pkg <- if (is.null(path)) "distributed_tpu_torch" else path
  reticulate::py_install(pkg, envname = envname, pip = TRUE)
}

#' Framework version string: confirms the R->Python binding resolves.
#' @export
dtpu_version <- function() {
  dtpu()$`__version__`
}

#' @export
`%>%` <- function(lhs, rhs) {
  # Minimal forward pipe so the keras-style `model %>% fit(...)` UX works
  # without a magrittr dependency; uses magrittr's if installed.
  if (requireNamespace("magrittr", quietly = TRUE)) {
    return(eval(call("%>%", substitute(lhs), substitute(rhs)),
                envir = list("%>%" = magrittr::`%>%`),
                enclos = parent.frame()))
  }
  rhs_call <- substitute(rhs)
  if (is.call(rhs_call)) {
    as_list <- as.list(rhs_call)
    new_call <- as.call(c(as_list[[1]], substitute(lhs), as_list[-1]))
    eval(new_call, envir = parent.frame())
  } else {
    (rhs)(lhs)
  }
}
