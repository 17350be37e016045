"""HDFS namenode resolution and HA failover (the port's copy of
``petastorm_tpu/hdfs/``)."""
