# Local single-host smoke test from R on the PyTorch/CUDA port: the
# reference's per-worker validation step ("make sure the workers are
# properly configured by training a local model first", README.md:25,
# 45-76). `device` is the GPU (NULL) unless the R option
# distributedtputorch.device names another (options(...) = "cpu").

library(distributedtputorch)

device <- getOption("distributedtputorch.device")

batch_size <- 64L
num_classes <- 10L
epochs <- 3L

mnist <- dataset_mnist()   # reshape + /255 already applied

model <- dtpu_model(mnist_cnn(num_classes), device = device)
model %>% compile(
  optimizer = "sgd", learning_rate = 0.001,
  loss = "sparse_categorical_crossentropy",
  metrics = c("accuracy")
)

model %>% fit(
  mnist$train$x, mnist$train$y,
  batch_size = batch_size,
  epochs = epochs,
  steps_per_epoch = 5L
)
