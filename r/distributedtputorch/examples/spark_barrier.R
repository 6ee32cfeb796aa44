# Spark barrier-mode gang launch on the PyTorch/CUDA port, mirroring the
# reference's sparklyr::spark_apply(barrier = TRUE) flow (README.md:170-247):
# one partition per worker (one GPU each), rank + peer list from the
# barrier context, the gang joined before the strategy is built, model
# returned to the driver base64-encoded from rank 0.
#
# The built-in launcher (`python -m distributed_tpu_torch.launch`) does the
# same without Spark; this script keeps the Spark path working for shops
# whose scheduling runs through YARN/Spark.

library(sparklyr)

config <- spark_config()
config$spark.dynamicAllocation.enabled <- FALSE
config$sparklyr.apply.env.WORKON_HOME <- "/tmp/.virtualenvs"
config$spark.executor.instances <- 3

sc <- spark_connect(master = "yarn", config = config)

result <- sdf_len(sc, 3, repartition = 3) %>%
  spark_apply(
    function(df, barrier) {
      tryCatch({
        library(distributedtputorch)
        device <- getOption("distributedtputorch.device")

        # rank + peers from the barrier context (README.md:180-183)
        barrier_cluster_spec(barrier$address, barrier$partition)
        initialize_cluster(device = device)

        batch_size <- 64L
        num_workers <- 3L

        mnist <- dataset_mnist()
        strategy <- multi_worker_mirrored_strategy(device = device)
        model <- with_strategy_scope(strategy, {
          m <- dtpu_model(mnist_cnn(10L))
          m %>% compile(optimizer = "sgd", learning_rate = 0.001,
                        loss = "sparse_categorical_crossentropy",
                        metrics = c("accuracy"))
          m
        })
        result <- model %>% fit(
          mnist$train$x, mnist$train$y,
          batch_size = batch_size * num_workers,
          epochs = 3L, steps_per_epoch = 5L, verbose = 0L
        )

        # rank 0 returns the model itself, base64 through the result
        # column (README.md:236-247); others return max accuracy.
        if (barrier$partition == 0) {
          save_model_hdf5(model, "trained-0.hdf5")
          base64enc::base64encode("trained-0.hdf5")
        } else {
          as.character(max(result$metrics$accuracy))
        }
      }, error = function(e) e$message)
    },
    barrier = TRUE,
    columns = c(address = "character")
  ) %>%
  collect()

# Driver: decode rank 0's model for scoring (README.md:246).
writeBin(base64enc::base64decode(result$address[1]), "model.hdf5")
