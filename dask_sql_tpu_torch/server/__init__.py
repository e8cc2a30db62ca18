"""The Presto-wire HTTP front end of the port (`app.run_server`), a copy of
`dask_sql_tpu/server/` over the port's serving runtime."""
