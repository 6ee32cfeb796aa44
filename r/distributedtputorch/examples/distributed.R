# Distributed data-parallel training from R on the PyTorch/CUDA port,
# mirroring the reference's 4-worker script (README.md:82-154): cluster
# spec + joining the gang + strategy scope + global batch multiplier. Run
# the SAME script on every host with its own index (worker 0 is the
# chief); each worker drives one GPU (`device` NULL), or the CPU when the
# R option distributedtputorch.device says "cpu".

library(distributedtputorch)

device <- getOption("distributedtputorch.device")

# --- cluster spec (one line differs per machine: index) --------------------
workers <- c("10.0.0.1:10087", "10.0.0.2:10088",
             "10.0.0.3:10089", "10.0.0.4:10090")
set_cluster_spec(workers, index = 0L)
initialize_cluster(device = device)   # blocks until every worker joined

batch_size <- 64L
num_workers <- 4L
epochs <- 3L

mnist <- dataset_mnist()

strategy <- multi_worker_mirrored_strategy(device = device)

model <- with_strategy_scope(strategy, {
  m <- dtpu_model(mnist_cnn(10L))
  m %>% compile(
    optimizer = "sgd", learning_rate = 0.001,
    loss = "sparse_categorical_crossentropy",
    metrics = c("accuracy")
  )
  m
})

model %>% fit(
  mnist$train$x, mnist$train$y,
  batch_size = batch_size * num_workers,   # global batch (README.md:124-125)
  epochs = epochs,
  steps_per_epoch = 5L
)

# Rank-0 model export for retrieval (README.md:236-247).
model %>% save_model_hdf5("trained.hdf5")
