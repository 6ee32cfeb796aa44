# Dataset loaders, mirroring keras::dataset_mnist() but returning data
# already in NHWC float form (reshape and /255 folded in by default). The
# arrays are host arrays: the model, or the strategy it was built under,
# moves each batch to its device.

.load_split <- function(name, normalize) {
  d <- dtpu()$data$load(name, "train", normalize = normalize)
  t <- dtpu()$data$load(name, "test", normalize = normalize)
  list(
    train = list(x = d[[1]], y = d[[2]]),
    test = list(x = t[[1]], y = t[[2]])
  )
}

#' MNIST in the keras dataset_mnist() shape: list(train=list(x,y), test=...).
#' @export
dataset_mnist <- function(normalize = TRUE) .load_split("mnist", normalize)

#' @export
dataset_fashion_mnist <- function(normalize = TRUE) {
  .load_split("fashion_mnist", normalize)
}

#' @export
dataset_cifar10 <- function(normalize = TRUE) .load_split("cifar10", normalize)
